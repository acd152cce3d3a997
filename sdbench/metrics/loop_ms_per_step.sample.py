"""Device ms per sampling step of the replayed reverse loop: CUDA events around each
LatentDiffusion.sample call of the window (its negative-prompt encode included), total
over the total steps (moves images_per_s)."""


def read(rec):
    ms = rec.get("loop_ms") or []
    return sum(ms) / (len(ms) * rec["steps"]) if ms else None
