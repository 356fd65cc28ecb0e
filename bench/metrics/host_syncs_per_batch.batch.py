"""Host reads of the BSP window loop per batch: the engine's own counter
``TraversalEngine.host_syncs`` over the window, divided by the batches."""


def read(record):
    syncs, batches = record["counters"].get("engine.host_syncs"), record["loop"].get("batches")
    if syncs is None or not batches:
        return None
    return syncs / batches
