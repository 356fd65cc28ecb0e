"""Host seconds of the program's partitioner (``bfs_grow_partition``) in
set-up, by the host clock around the call."""


def read(record):
    return record["spans"]["partition_s"]
