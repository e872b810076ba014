"""Host seconds of a frame's load as the driver logs it (its read, alignment
and build, from its own clock), over the run's frames: what the load costs
whether or not the card waits for it. A faster data path moves it; a load
that overlaps the previous frame's steps does not."""


def read(run):
    logged = run["drive"]["logged_load_s"]
    if run["trace"] is None or not logged:
        return None
    return sum(logged) / len(logged)
