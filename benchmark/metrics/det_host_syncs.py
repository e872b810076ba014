"""Host calls per training step that wait on the device inside the detector
step's stages (``stages.SYNC_CALLS``: stream, device and event
synchronizations and blocking copies), from the profiled steps
(``runs/detector.py::stage_split``). The chunk's copy of its losses to the
host falls outside every step."""

STAGES = ("det.backbone", "det.transformer", "det.match", "det.loss", "det.backward",
          "det.optim")


def read(run):
    stages = run["stages"]
    if run["trace"] is None or stages is None or "syncs" not in stages:
        return None
    return sum(stages["syncs"].get(stage, 0.0) for stage in STAGES)
