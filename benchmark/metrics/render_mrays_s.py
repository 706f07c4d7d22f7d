"""render_mrays_s: traced segments (one ray cast by a live path) of the units the
window completed, over the window's seconds, in millions. The segments are counted
on the same sample streams by the program's kernel statistics after the window (the
check holds them against the reference's at pixel blocks)."""


def read(run):
    seg = run.counts.get("segments")
    return None if seg is None else seg / run.window.seconds / 1e6
