"""Share of the batches' wall (demux included) spent in the native entropy
front-end: ``BatchDecoder.last_stats["stages"]["frontend"]``, read in the
traced run only, where ``stage_sync`` ends each device stage with a
synchronize so the stages do not overlap."""


def read(run):
    walls = sum(b["wall_s"] for b in run.batches)
    front = sum(b["stages"].get("frontend", 0.0) for b in run.batches)
    if not walls or not front:
        return None
    return 100.0 * front / walls
