"""The partition counters' scan work per batch: the engine's own counter
``TraversalEngine.scan_elems`` (rows × n of every ``_part_sums`` scan) over
the window, divided by the batches."""


def read(record):
    elems, batches = record["counters"].get("engine.scan_elems"), record["loop"].get("batches")
    if elems is None or not batches:
        return None
    return elems / batches
