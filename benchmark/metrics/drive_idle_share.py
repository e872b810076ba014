"""Per cent of the driver's wall time, from its entry to the end of its last
frame's last step, in which the card waits between frames (the sum of the
waits that ``load_s`` takes its mean of, the benchmark's captures taken out
of both), on the host clock."""


def read(run):
    drive = run["drive"]
    if run["trace"] is None or not drive["waits_s"]:
        return None
    return 100.0 * sum(drive["waits_s"]) / drive["wall_s"]
