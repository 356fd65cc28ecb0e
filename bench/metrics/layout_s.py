"""Host seconds of the first ``GraphSession.engine`` call (edge layout,
device arrays, relax indexing), by the host clock between two
synchronizations."""


def read(record):
    return record["spans"]["layout_s"]
