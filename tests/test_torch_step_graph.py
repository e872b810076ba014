"""The optimization step as CUDA graphs replay it (``pipeline/step_graph.py``).

On the CPU: the exclusive cumulative product's backward against
``torch.cumprod``'s autograd in float64 (exact zeros at a row's start, in
its middle, at its end, twice), with no read of a device value; a warm step
that reads nothing back; Adam's per-step scalars as the host's f32
arithmetic; ``Adam.step``'s three arguments as the whole update; which steps stay eager (the CPU, a ray-sharded step, the
photometric branch), counted in ``eager_steps``; and the
graph table's lifetime rules.

On the card (marker ``gpu``; the file imports no JAX): replay against the
eager step, bit for bit, after 60 steps across a metric step and the
warmup/residual boundary at F=1 with N=8 (the subset DP), F=1 with N=32
(JV) and F=8 with N=8; a probe-style fresh state replaying an existing
graph; a second frame replacing the first frame's graph, the memory
returning to its level; and each field kernel's launch counter advancing
once per replayed step.

Run the card half with ``python -m pytest tests/test_torch_step_graph.py -m gpu``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from vsrd_tpu_torch.pipeline import frame as fm, optimize as opt, sharded, step_graph
from vsrd_tpu_torch.rendering import field_kernels as fk, renderer

torch.set_num_threads(2)

CPU_CFG = opt.OptimizationConfig(num_steps=8, warmup_steps=2, num_rays=8, num_samples=4,
                                 checkpoint_interval=4, metric_interval=100)


class HostReads(TorchDispatchMode):
    """Counts the operations that copy a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def _exclusive_reference(x):
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


@pytest.mark.parametrize("zeros", [(), (0,), (3,), (6,), (2, 5), (0, 6)])
def test_exclusive_cumprod_backward_matches_cumprod_autograd(zeros):
    rng = np.random.default_rng(len(zeros) + sum(zeros))
    x = torch.from_numpy(rng.uniform(0.2, 1.5, size=(3, 7)))
    x[1, list(zeros)] = 0.0
    grad = torch.from_numpy(rng.normal(size=(3, 7)))
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    out = renderer.exclusive_cumprod(a)
    expected = _exclusive_reference(b)
    np.testing.assert_array_equal(out.detach().numpy(), expected.detach().numpy())
    reads = HostReads()
    with reads:
        (got,) = torch.autograd.grad(out, a, grad)
    (want,) = torch.autograd.grad(expected, b, grad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
    assert reads.reads == 0
    if not zeros:
        # without zeros the same operations as PyTorch's own backward
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def _cpu_frame(seed=0, **kw):
    return fm.synthetic_frame(seed, num_views=2, image_size=(24, 32), num_instances=2,
                              max_instances=3, device="cpu", **kw)


def test_a_warm_step_reads_nothing_back():
    """After one step of each phase has made the device constants, a step
    of either phase copies no value to the host (on a card: no wait)."""
    frame = _cpu_frame()
    params = opt.init_params(torch.Generator().manual_seed(0), 3, CPU_CFG)
    adam = opt.Adam(CPU_CFG)
    state = adam.init(params)
    rows = opt.chunk_scalars(CPU_CFG, adam, 0, 0, 4, "cpu")
    for step in range(4):
        reads = HostReads()
        with reads:
            opt.train_step(params, state, frame, step, CPU_CFG, adam,
                           opt.step_generator(1, step, "cpu"), scalars=rows[step])
        if step in (1, 3):
            assert reads.reads == 0, step


def test_adam_step_scalars_are_the_host_f32_arithmetic():
    """The decayed step size and the bias corrections' reciprocals per
    group, each the f32 number the JAX optimizer's order of operations
    gives (the reciprocal as a card takes it to divide by a host number)."""
    cfg = opt.OptimizationConfig(warmup_steps=5)
    adam = opt.Adam(cfg)
    f32 = np.float32
    for count in (0, 3, 5, 6, 2999):
        got = adam.step_scalars(count)
        c = f32(count)
        decay = f32(cfg.lr_decay) ** c
        expected = []
        for lr, offset in ((cfg.box_lr, 0.0), (cfg.embedding_lr, 5.0), (cfg.hypernetwork_lr, 5.0)):
            t = max(c + f32(1.0) - f32(offset), f32(1.0))
            expected += [f32(-lr) * decay, f32(1.0) / (f32(1.0) - f32(adam.b1) ** t),
                         f32(1.0) / (f32(1.0) - f32(adam.b2) ** t)]
        assert got.dtype == np.float32 and got.shape == (opt.Adam.NUM_SCALARS,)
        np.testing.assert_array_equal(got, np.asarray(expected, np.float32))
    table = opt.chunk_scalars(cfg, adam, 7, 3, 2, "cpu")
    np.testing.assert_array_equal(table[:, 0].numpy(), [7.0, 8.0])
    np.testing.assert_array_equal(table[1, 1:].numpy(), adam.step_scalars(4))


def test_a_replaced_adam_step_stands_in_for_the_whole_update(monkeypatch):
    """``Adam.step(params, grads, state)`` is the update's whole interface:
    a stand-in with those three arguments that does nothing leaves the
    parameters and the moments as they were, the step's scalars reaching
    the real one through ``scalars_from``."""
    frame = _cpu_frame()
    params = opt.init_params(torch.Generator().manual_seed(0), 3, CPU_CFG)
    adam = opt.Adam(CPU_CFG)
    state = adam.init(params)
    before = [t.clone() for t in opt._state_leaves(params, state)]
    monkeypatch.setattr(opt.Adam, "step", lambda self, params, grads, state: None)
    opt.optimize_chunk(params, state, frame, 1, 0, CPU_CFG, 4, adam)
    for got, want in zip(opt._state_leaves(params, state), before):
        assert torch.equal(got, want)
    assert adam._given is None


def test_cpu_steps_stay_eager_and_are_counted():
    graphs = step_graph.graphs
    graphs.reset_counts()
    opt.optimize_frame(_cpu_frame(), 0, CPU_CFG)
    assert (graphs.eager_steps, graphs.replays, graphs.captures) == (CPU_CFG.num_steps, 0, 0)


def test_the_photometric_branch_stays_eager_and_is_counted():
    cfg = opt.OptimizationConfig(num_steps=6, warmup_steps=2, num_rays=48, num_samples=8,
                                 checkpoint_interval=6, metric_interval=100,
                                 photometric_weight=0.1, surface_num_rays=16,
                                 surface_num_iterations=24)
    graphs = step_graph.graphs
    graphs.reset_counts()
    frame = fm.synthetic_frame(0, num_views=3, image_size=(48, 64), num_instances=2,
                               max_instances=2, with_images=True, device="cpu")
    _, scalars = opt.optimize_frame(frame, 3, cfg)
    assert scalars["photometric_loss"][2:].any()
    assert (graphs.eager_steps, graphs.replays, graphs.captures) == (6, 0, 0)


def test_a_ray_sharded_step_stays_eager_and_is_counted(tmp_path):
    """``train_step`` with ``sp_group`` (a group of one process here) is the
    eager step; ``optimize_chunk``, the only caller that replays, takes no
    group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        frame = _cpu_frame()
        params = opt.init_params(torch.Generator().manual_seed(0), 3, CPU_CFG)
        adam = opt.Adam(CPU_CFG)
        state = adam.init(params)
        graphs = step_graph.graphs
        graphs.reset_counts()
        for step in range(3):
            scalars = opt.train_step(params, state, frame, step, CPU_CFG, adam,
                                     opt.step_generator(1, step, "cpu"),
                                     sp_group=dist.group.WORLD)
            assert torch.isfinite(scalars["loss"])
        assert (graphs.eager_steps, graphs.replays, graphs.captures) == (3, 0, 0)
    finally:
        dist.destroy_process_group()


class _FrameOnCard:
    """What ``_graph_key`` reads of a frame, on a card that need not exist."""

    def __init__(self, gray_images=None):
        self.device = torch.device("cuda", 0)
        self.gray_images = gray_images


def test_the_graph_key_leaves_only_graph_safe_steps_to_the_graph():
    params = opt.init_params(torch.Generator().manual_seed(0), 3, CPU_CFG)
    photometric = opt.OptimizationConfig(photometric_weight=0.1)
    with_images = _FrameOnCard(gray_images=torch.zeros(1))
    for use_rdf in (False, True):
        assert opt._graph_key(params, _FrameOnCard(), CPU_CFG, use_rdf) is not None
        assert opt._graph_key(params, _cpu_frame(), CPU_CFG, use_rdf) is None
        # the photometric branch runs in the residual phase, on frames with images
        assert (opt._graph_key(params, with_images, photometric, use_rdf) is None) == use_rdf
        assert opt._graph_key(params, _FrameOnCard(), photometric, use_rdf) is not None
    warm = opt._graph_key(params, _FrameOnCard(), CPU_CFG, False)
    assert warm != opt._graph_key(params, _FrameOnCard(), CPU_CFG, True)
    other = opt._graph_key(opt.init_params(torch.Generator().manual_seed(0), 4, CPU_CFG),
                           _FrameOnCard(), CPU_CFG, False)
    assert warm != other


def test_a_new_frame_replaces_the_keys_entry_and_a_frames_death_drops_it():
    table = step_graph.StepGraphs()
    first, second = _FrameOnCard(), _FrameOnCard()
    entry = table.entry("key", first)
    entry.warm = True
    assert table.entry("key", first) is entry
    released = []
    entry.release = lambda: released.append(entry)
    replaced = table.entry("key", second)
    assert replaced is not entry and not replaced.warm and released == [entry]
    assert table.entry("other", second) is not replaced
    ref = weakref.ref(second)
    del second
    gc.collect()
    assert ref() is None and table._entries == {}


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


CARD_CFG = opt.OptimizationConfig(num_steps=100, warmup_steps=30, num_rays=256, num_samples=24,
                                  metric_interval=25)


def _card_case(frames: int, n: int, seed: int = 0):
    """A frame (stacked for ``frames`` > 1) with ``n`` instance slots, all
    valid, and its initial parameters."""
    made = [fm.synthetic_frame(seed + f, num_views=4, image_size=(96, 128), num_instances=n,
                               max_instances=n, layout="kitti" if n > 8 else "compact",
                               device="cuda") for f in range(frames)]
    if frames == 1:
        frame = made[0]
        params = opt.tree_map(lambda t: t.cuda(), opt.init_params(
            torch.Generator().manual_seed(seed), n, CARD_CFG))
    else:
        frame = sharded.stack_frames(made)
        params = opt.init_params_batched(seed, frames, n, CARD_CFG, device="cuda")
    return frame, params


def _clone_state(state):
    return {"mu": opt.tree_map(torch.clone, state["mu"]),
            "nu": opt.tree_map(torch.clone, state["nu"]), "count": state["count"]}


def _eager(params, state, frame, seed, start, steps, cfg=CARD_CFG):
    """The eager steps, with the chunk's numbers as ``optimize_chunk`` makes them."""
    adam = opt.Adam(cfg)
    rows = opt.chunk_scalars(cfg, adam, start, state["count"], steps, frame.device)
    out = []
    for i, step in enumerate(range(start, start + steps)):
        scalars = opt.train_step(params, state, frame, step, cfg, adam,
                                 opt.step_generator(seed, step, frame.device), scalars=rows[i])
        out.append(torch.stack([scalars[name] for name in opt.SCALAR_NAMES]))
    return torch.stack(out).cpu().numpy()


def _assert_same_state(p1, s1, p2, s2):
    assert s1["count"] == s2["count"]
    for tree1, tree2 in ((p1, p2), (s1["mu"], s2["mu"]), (s1["nu"], s2["nu"])):
        for (path, a), (_, b) in zip(opt.tree_leaves(tree1), opt.tree_leaves(tree2)):
            assert torch.equal(a, b), path


@pytest.mark.gpu
@pytest.mark.parametrize("frames, n", [(1, 8), (1, 32), (8, 8)])
def test_replay_is_the_eager_step_bit_for_bit_on_card(cuda, frames, n):
    """60 steps from step 10 in chunks of 20 (a metric step at 24 and 49,
    the residual field from 30) against the eager steps."""
    frame, params = _card_case(frames, n)
    adam = opt.Adam(CARD_CFG)
    eager_params = opt.tree_map(torch.clone, params)
    eager_state = adam.init(eager_params)
    state = adam.init(params)
    graphs = step_graph.graphs
    graphs.reset_counts()
    chunks = [opt.optimize_chunk(params, state, frame, 7, start, CARD_CFG, 20, adam)
              for start in (10, 30, 50)]
    assert graphs.captures == 2 and graphs.eager_steps == 2 and graphs.replays == 58
    expected = _eager(eager_params, eager_state, frame, 7, 10, 60)
    _assert_same_state(params, state, eager_params, eager_state)
    for j, name in enumerate(opt.SCALAR_NAMES):
        got = np.concatenate([chunk[name] for chunk in chunks])
        np.testing.assert_array_equal(got, expected[:, j], err_msg=name)
    matched = np.concatenate([chunk["num_matched"] for chunk in chunks])
    assert np.all(np.asarray(matched[[14, 39]]) == n)        # steps 24 and 49


@pytest.mark.gpu
def test_a_fresh_state_replays_the_existing_graph_on_card(cuda):
    """As the benchmark's probes do: a fresh copy of the parameters and a
    fresh Adam state at later steps, one step each, through the graph that
    the first state's steps captured."""
    frame, initial = _card_case(1, 8)
    adam = opt.Adam(CARD_CFG)
    params = opt.tree_map(torch.clone, initial)
    state = adam.init(params)
    opt.optimize_chunk(params, state, frame, 3, 30, CARD_CFG, 3, adam)
    graphs = step_graph.graphs
    captures = graphs.captures
    for start in (40, 55):
        fresh = opt.tree_map(torch.clone, initial)
        fresh_state = adam.init(fresh)
        got = opt.optimize_chunk(fresh, fresh_state, frame, 3, start, CARD_CFG, 1, adam)
        eager = opt.tree_map(torch.clone, initial)
        eager_state = adam.init(eager)
        expected = _eager(eager, eager_state, frame, 3, start, 1)
        _assert_same_state(fresh, fresh_state, eager, eager_state)
        np.testing.assert_array_equal(got["loss"], expected[:, 0])
    assert graphs.captures == captures


@pytest.mark.gpu
def test_a_new_frame_replaces_the_graph_and_frees_its_memory_on_card(cuda):
    # the level: what a process keeps once it has captured (the capture
    # stream's cuBLAS workspace, the device constants, the generator's state)
    scratch, initial = _card_case(1, 8, seed=2)
    adam = opt.Adam(CARD_CFG)
    opt.optimize_chunk(initial, adam.init(initial), scratch, 3, 30, CARD_CFG, 2, adam)
    del scratch, initial          # the frame's death frees its graph
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    first, initial = _card_case(1, 8, seed=0)
    second = _card_case(1, 8, seed=1)[0]
    params = opt.tree_map(torch.clone, initial)
    state = adam.init(params)
    graphs = step_graph.graphs
    captures = graphs.captures
    opt.optimize_chunk(params, state, first, 3, 30, CARD_CFG, 3, adam)
    torch.cuda.synchronize()
    one_graph = torch.cuda.memory_allocated()
    opt.optimize_chunk(params, state, second, 3, 33, CARD_CFG, 3, adam)
    torch.cuda.synchronize()
    assert graphs.captures == captures + 2
    assert abs(torch.cuda.memory_allocated() - one_graph) <= 1 << 20
    del first, second, params, state, initial
    gc.collect()
    torch.cuda.synchronize()
    assert step_graph.graphs._entries == {}
    assert abs(torch.cuda.memory_allocated() - base) <= 1 << 16


@pytest.mark.gpu
def test_each_field_kernel_counts_one_launch_per_replayed_step_on_card(cuda):
    frame, params = _card_case(1, 8)
    adam = opt.Adam(CARD_CFG)
    state = adam.init(params)
    opt.optimize_chunk(params, state, frame, 5, 30, CARD_CFG, 2, adam)
    fk.reset_launch_counts()
    replays = step_graph.graphs.replays
    opt.optimize_chunk(params, state, frame, 5, 32, CARD_CFG, 10, adam)
    assert step_graph.graphs.replays == replays + 10
    for launcher in (fk.field_forward, fk.field_backward, fk.field_dir_forward):
        assert launcher.launches == 10, launcher.__name__
    assert fk.field_forward.rdf_launches == fk.field_backward.rdf_launches == 10
    assert fk.field_dir_forward.rdf_launches == 0     # the box-only coarse pass
