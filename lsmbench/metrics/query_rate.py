"""query_rate (Mquery/s): lookup keys plus count and range windows answered
in the window, over the window's seconds. Host clock."""

QUERIES = ("lookup", "count", "range")


def read(run):
    if not any(run.latency_s[op] for op in QUERIES):
        return None
    return sum(run.work[op] for op in QUERIES) / run.window_s / 1e6
