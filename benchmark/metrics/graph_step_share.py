"""Per cent of the run's optimization steps that replayed a CUDA graph: the
port's step-graph counters (``vsrd_tpu_torch/pipeline/step_graph.py``), read
in the run's own process, as replays over replays and eager steps. A run
without the card's trace (so on the CPU, where every step is eager) or a port
without those counters gives nothing to read."""

import importlib.util


def read(run):
    spec = importlib.util.find_spec("vsrd_tpu_torch.pipeline.step_graph")
    if run["trace"] is None or spec is None:
        return None
    from vsrd_tpu_torch.pipeline.step_graph import graphs
    steps = graphs.replays + graphs.eager_steps
    return 100.0 * graphs.replays / steps if steps else None
