"""The relax kernel's share of its roofline over the traced batches: the
least time of each call (``bench.roofline``; the local calls are the
batches' closure iterations, the remote calls their supersteps, which must
equal the kernel's own launch counter) over the device time the trace gives
the kernels whose name holds ``relax_``, in percent."""

from bench import roofline


def read(record):
    trace, peaks, calls = record["trace"], record["peaks"], record["loop"].get("relax_traced")
    if trace is None or peaks is None or not calls or not calls["batches"]:
        return None
    if calls["local_calls"] + calls["remote_calls"] != calls["launches"]:
        return None
    device_s = sum(s for name, s in trace["device_s_by_name"].items() if "relax_" in name)
    if device_s <= 0:
        return None
    shape = record["relax_shapes"]
    s, n = shape["s"], shape["n"]
    least = calls["local_calls"] * roofline.relax_least_seconds(s, n, shape["e_local"], peaks)
    least += calls["remote_calls"] * roofline.relax_least_seconds(s, n, shape["e_remote"], peaks)
    return 100.0 * least / device_s
