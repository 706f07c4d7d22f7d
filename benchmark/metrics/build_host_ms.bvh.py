"""build_host_ms.bvh: host ms a job in the BVH build (the span `bvh.build`: the
vertices' copy from the card and the native or numpy build), inside the job's
`driver.prepare` or `sorted.prepare`."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "bvh.build")
