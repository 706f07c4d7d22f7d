"""probe_rows.vertex: rows a vertex step sends to the arbitrary-ray probe kernel, from
the program's counter `vertex.probe_rows` (read in set-up's steps, a size the host
knows): its silhouettes' and its light rim's probes, whose buffers and pairwise rim
tensors scale with it. None where the program keeps no such counter."""


def read(run):
    rows = run.counts.get("probe_rows")
    if rows is None or not run.window.units:
        return None
    return rows / run.window.units
