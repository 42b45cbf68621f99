"""Training with the port on the CPU against the JAX package's trainer
(``cbinfer_tpu/train.py``): ``video.pose_targets``, the training data and
batches, the losses and gradients, the learning-rate schedule, three Adam
steps from the same initial weights, a falling loss over 30 steps, and the
entry points' refusal of ``device="cuda"`` without a card.

Small nets: a scene chain of width 8 at 48x64, the pose chain of
``tests/test_pose_supervision.py::test_train_pose_smoke`` at 48x64, and
``pose_graph(width=8)`` at 64x64.

Why three Adam steps are compared in layers and not by one ``allclose``:
Adam's first steps move every parameter by about ``lr * sign(g)``,
whatever ``|g|``. A gradient entry near zero whose sign differs by
rounding between XLA and PyTorch (another summation order) moves the other
way, up to ``2 * lr`` apart after one step. So the per-step losses must
agree within 1e-4 relative, at least 99.9% of the parameter entries within
1e-5 + 1e-4 * |p|, and every entry within ``2 * lr * steps``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from cbinfer_tpu import graph as jgraph
from cbinfer_tpu import network as jnetwork
from cbinfer_tpu import train as jtrain
from cbinfer_tpu import video as jvideo
from cbinfer_tpu.config import ConvSpec as JConv
from cbinfer_tpu.config import PoolSpec as JPool
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.models.pose import pose_graph as j_pose_graph
from cbinfer_tpu.network import dense_apply as j_dense_apply
from cbinfer_tpu.network import init_params as j_init_params

from cbinfer_tpu_torch import network, train
from cbinfer_tpu_torch import video as tvideo
from cbinfer_tpu_torch.checkpoint import (graph_params_from_numpy,
                                          params_from_numpy)
from cbinfer_tpu_torch.config import ConvSpec, PoolSpec
from cbinfer_tpu_torch.graph import convert_graph
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.models.pose import pose_graph

SEED = 0
STEPS = 3
NP = tvideo.NUM_PAFS + tvideo.NUM_KEYPOINTS


def _pose_chain(conv, pool):
    return [conv(features=8, kernel=(3, 3)), pool(window=(2, 2), stride=(2, 2)),
            conv(features=8, kernel=(3, 3)), pool(window=(2, 2), stride=(2, 2)),
            conv(features=8, kernel=(3, 3)), pool(window=(2, 2), stride=(2, 2)),
            conv(features=NP, kernel=(1, 1), activation=None)]


# kind -> (the port's model, the reference's, input shape, trainer kwargs)
CASES = {
    "seg": (lambda: get_model("scene", num_classes=8, width=8),
            lambda: j_get_model("scene", num_classes=8, width=8),
            (48, 64, 3), dict(batch=2, n_videos=2)),
    "seg_noise": (lambda: get_model("scene", num_classes=8, width=8),
                  lambda: j_get_model("scene", num_classes=8, width=8),
                  (48, 64, 3), dict(batch=2, n_videos=2, input_noise=0.05)),
    "pose": (lambda: _pose_chain(ConvSpec, PoolSpec),
             lambda: _pose_chain(JConv, JPool),
             (48, 64, 3), dict(batch=2, n_videos=2, frames_per_video=2)),
    "pose_graph": (lambda: pose_graph(width=8), lambda: j_pose_graph(width=8),
                   (64, 64, 3), dict(batch=2, n_videos=2,
                                     frames_per_video=2)),
}
LR = {"seg": 3e-3, "seg_noise": 3e-3, "pose": 2e-3, "pose_graph": 2e-3}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(params):
    """Every weight and bias as numpy, in layer (or sorted node) order."""
    pairs = ([params[k] for k in sorted(params)] if isinstance(params, dict)
             else [p for p in params if p is not None])
    out = []
    for p in pairs:
        for t in p:
            if t is not None:
                out.append(t.detach().numpy() if isinstance(t, torch.Tensor)
                           else np.asarray(t))
    return out


def _ref_init(kind):
    """The reference trainer's initial params, as numpy."""
    _, jmodel, shape, _ = CASES[kind]
    key = jax.random.PRNGKey(SEED)
    if kind == "pose_graph":
        nodes, _ = jmodel()
        p = jgraph.init_graph_params(nodes, shape, key)
        return {k: tuple(None if t is None else np.asarray(t) for t in v)
                for k, v in p.items()}
    p = j_init_params(jmodel(), shape, key)
    return [None if v is None else tuple(
        None if t is None else np.asarray(t) for t in v) for v in p]


def _carried(kind, device="cpu"):
    """The reference's initial params as the port's tensors."""
    tmodel = CASES[kind][0]
    if kind == "pose_graph":
        return graph_params_from_numpy(tmodel()[0], _ref_init(kind), device)
    return params_from_numpy(tmodel(), _ref_init(kind), device)


class _JaxRecorder:
    """``jax`` for the reference trainer's module: ``jit`` records each
    step's batch (args 2 and 3) and loss (output 2)."""

    def __init__(self, record):
        self._record = record

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, f):
        jf = jax.jit(f)

        def step(*args):
            out = jf(*args)
            self._record.append((np.asarray(args[2]), np.asarray(args[3]),
                                 float(out[2])))
            return out
        return step


def _run_reference(kind, steps=STEPS):
    tmodel, jmodel, shape, kw = CASES[kind]
    record = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "jax", _JaxRecorder(record))
        if kind.startswith("seg"):
            params, metric = jtrain.train_segmentation(
                jmodel(), shape, 8, steps=steps, seed=SEED, **kw)
        elif kind == "pose":
            params, metric = jtrain.train_pose(jmodel(), shape, steps=steps,
                                               seed=SEED, **kw)
        else:
            nodes, out = jmodel()
            params, metric = jtrain.train_pose_graph(
                nodes, out, shape, steps=steps, seed=SEED, **kw)
    return dict(params=params, metric=metric, batches=record)


def _run_port(kind, steps=STEPS, carried=True, device="cpu"):
    tmodel, _, shape, kw = CASES[kind]
    batches, losses = [], []
    with pytest.MonkeyPatch.context() as mp:
        if carried:
            init = _carried(kind, device)
            mp.setattr(train, "init_params", lambda *a, **k: init)
            mp.setattr(train, "init_graph_params", lambda *a, **k: init)
        seg_loss, pose_loss = train.seg_loss, train.pose_loss

        def rec_seg(forward, params, x, y):
            batches.append((x.detach().cpu().numpy().copy(),
                            y.cpu().numpy().copy()))
            return seg_loss(forward, params, x, y)

        def rec_pose(forward, params, x, y, *a):
            batches.append((x.detach().cpu().numpy().copy(),
                            y.cpu().numpy().copy()))
            return pose_loss(forward, params, x, y, *a)
        mp.setattr(train, "seg_loss", rec_seg)
        mp.setattr(train, "pose_loss", rec_pose)
        common = dict(steps=steps, seed=SEED, device=device, losses=losses,
                      **kw)
        if kind.startswith("seg"):
            params, metric = train.train_segmentation(tmodel(), shape, 8,
                                                      **common)
        elif kind == "pose":
            params, metric = train.train_pose(tmodel(), shape, **common)
        else:
            nodes, out = tmodel()
            params, metric = train.train_pose_graph(nodes, out, shape,
                                                    **common)
    return dict(params=params, metric=metric, batches=batches,
                losses=[float(v) for v in losses])


@pytest.fixture(scope="module")
def runs():
    """Each case's reference run and the port's run from the carried
    initial params, STEPS steps each."""
    return {k: (_run_reference(k), _run_port(k)) for k in CASES}


# ------------------------------- (a) targets ---------------------------------


def test_pose_limb_parts_are_the_reference():
    assert tvideo.POSE_LIMB_PARTS == jvideo.POSE_LIMB_PARTS
    assert (tvideo.POSE_CLASSES, tvideo.POSE_PARTS, tvideo.NUM_KEYPOINTS,
            tvideo.NUM_PAFS) == (jvideo.POSE_CLASSES, jvideo.POSE_PARTS,
                                 jvideo.NUM_KEYPOINTS, jvideo.NUM_PAFS)


@pytest.mark.parametrize("case", range(6))
def test_pose_targets_equal_the_reference(case):
    """Random keypoints with some invalid, keypoints off the grid, and
    (cases 4, 5) zero-length limbs: every limb of some classes collapsed
    to one point."""
    rng = np.random.default_rng(case)
    K = tvideo.NUM_KEYPOINTS
    kps = rng.uniform(-8, 72, (K, 2)).astype(np.float32)
    valid = rng.uniform(size=K) < 0.7
    if case >= 4:
        for c in range(0, tvideo.POSE_CLASSES, 2):
            kps[c * 3:c * 3 + 3] = kps[c * 3]
            valid[c * 3:c * 3 + 3] = True
    if case == 5:
        valid[:] = False
        valid[:3] = True
    stride, sigma, width = (4, 2.0, 1.0) if case % 2 else (8, 3.0, 1.5)
    args = (kps, valid, 64 // stride, 80 // stride, stride, sigma, width)
    got, want = tvideo.pose_targets(*args), jvideo.pose_targets(*args)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    if case == 4:
        assert np.any(got[..., :tvideo.NUM_PAFS])  # other limbs drawn
    if case == 5:  # one class, its limbs of length zero: heat, no field
        assert not np.any(got[..., :tvideo.NUM_PAFS])
        assert np.any(got[..., tvideo.NUM_PAFS:])


def test_pose_targets_of_a_video_equal_the_reference():
    cfg = dict(height=64, width=96, n_sprites=5, sprite_size=16,
               distinct_classes=True, seed=4)
    tv = tvideo.SpriteVideo(tvideo.SpriteVideoConfig(**cfg))
    jv = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(**cfg))
    for _ in range(3):
        (k, v), (jk, jv_) = tv.pose_keypoints(), jv.pose_keypoints()
        assert np.array_equal(tvideo.pose_targets(k, v, 8, 12, 8, 2.0),
                              jvideo.pose_targets(jk, jv_, 8, 12, 8, 2.0))
        tv.step()
        jv.step()


# ----------------------------- (b) data, batches -----------------------------


@pytest.mark.parametrize("kw", [{}, dict(video_kwargs=dict(
    tvideo.GRADED_DYNAMICS))])
def test_pose_dataset_is_the_reference(kw):
    args = (48, 64, 6, 8, 8, 1, 5, 2)
    got = train._pose_dataset(*args, **kw)
    want = jtrain._pose_dataset(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", list(CASES))
def test_batches_are_the_reference(runs, kind):
    """The same frames (with the same noise draws), labels at the output
    stride or pose targets, step by step."""
    ref, port = runs[kind]
    assert len(ref["batches"]) == len(port["batches"]) == STEPS
    stride = 4 if kind.startswith("seg") else 1
    for (jx, jy, _), (tx, ty) in zip(ref["batches"], port["batches"]):
        assert np.array_equal(tx, jx)
        want = jy[:, ::stride, ::stride] if stride > 1 else jy
        assert np.array_equal(ty, want)


# --------------------------- (c) loss and gradients --------------------------


def _forward_pair(kind):
    """(port forward, reference forward) over one HWC frame."""
    tmodel, jmodel, shape, _ = CASES[kind]
    if kind == "pose_graph":
        (tn, to), (jn, jo) = tmodel(), jmodel()
        tnet = convert_graph(tn, shape, None, output=to)
        jnet = jgraph.convert_graph(jn, shape, output=jo)
        return tnet.apply_dense, jnet.apply_dense
    ts, js = tmodel(), jmodel()
    return ((lambda p, f: network.dense_apply(ts, p, f)),
            (lambda p, f: j_dense_apply(js, p, f)))


# frames of each case's training data in the gradient test's batch, clear
# of the forward's rounding (asserted by _margins)
GRAD_FRAMES = {"seg": [1, 3, 7], "pose": [1, 3], "pose_graph": [1, 3]}
MARGIN = 1e-6  # twice the largest forward difference seen (5e-7, float32)


def _batch(kind):
    _, _, (H, W, _), kw = CASES[kind]
    idx = GRAD_FRAMES[kind]
    if kind.startswith("seg"):
        fr, lab = train._seg_dataset(np.random.default_rng(SEED), H, W, SEED,
                                     kw["n_videos"])
        return fr[idx], lab[idx][:, ::4, ::4]
    fr, tg, _, _ = train._pose_dataset(H, W, H // 8, W // 8, 8, SEED, 2, 2)
    return fr[idx], tg[idx]


def _margins(kind, frames):
    """Over the reference's forward of ``frames``: the least |pre-
    activation| of a ReLU conv, and the least gap between the largest and
    the second largest value of a 2x2 pool window whose maximum is
    positive, exact ties (gap 0, the same winner in both) left out. A
    rounding difference between the two frameworks flips a ReLU or a
    pool's winner only inside these margins, and each flip moves a
    gradient entry by ~1e-3 of its scale at these sizes."""
    jm = CASES[kind][1]()
    params = _ref_init(kind)
    if kind == "pose_graph":
        seq = [(n.name, n.spec, n.inputs) for n in jm[0]]
    else:
        seq = [(i, s, (i - 1 if i else "input",)) for i, s in enumerate(jm)]
    relu, gap = np.inf, np.inf
    for f in frames:
        vals = {"input": np.asarray(f)}
        for name, spec, ins in seq:
            x = vals[ins[0]]
            if isinstance(spec, jgraph.ConcatSpec):
                y = np.concatenate([vals[i] for i in ins], -1)
            elif isinstance(spec, JConv):
                w, b = params[name]
                y = np.asarray(jnetwork.dense_conv(
                    jnp.asarray(x), w, b,
                    dataclasses.replace(spec, activation=None)))
                if spec.activation == "relu":
                    relu = min(relu, float(np.abs(y).min()))
                    y = np.maximum(y, 0)
            else:
                assert spec.window == spec.stride == (2, 2)
                H, W, C = x.shape
                win = np.sort(x[:H // 2 * 2, :W // 2 * 2].reshape(
                    H // 2, 2, W // 2, 2, C).transpose(0, 2, 4, 1, 3).reshape(
                    H // 2, W // 2, C, 4), -1)
                d = (win[..., -1] - win[..., -2])[(win[..., -1] > 0)
                                                  & (win[..., -1]
                                                     > win[..., -2])]
                gap = min(gap, float(d.min()) if d.size else np.inf)
                y = win[..., -1]
            vals[name] = y
    return relu, gap


def _ref_value_and_grad(kind, x, y):
    """The reference trainer's loss, rebuilt as ``cbinfer_tpu/train.py``
    builds it (``:84-89`` cross-entropy, ``:222-229`` weighted MSE)."""
    jfwd = _forward_pair(kind)[1]
    params = jax.tree.map(jnp.asarray, _ref_init(kind))
    if kind.startswith("seg"):
        def loss_fn(ps):
            logits = jax.vmap(lambda f: jfwd(ps, f))(x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
    else:
        cw = jnp.asarray(np.concatenate([
            np.ones((tvideo.NUM_PAFS,), np.float32),
            np.full((tvideo.NUM_KEYPOINTS,), 4.0, np.float32)]))

        def loss_fn(ps):
            pred = jax.vmap(lambda f: jfwd(ps, f))(x)
            w = cw * (1.0 + 30.0 * jnp.abs(y))
            return jnp.mean(w * (pred - y) ** 2)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), _leaves(grads)


@pytest.mark.parametrize("kind", ["seg", "pose", "pose_graph"])
def test_loss_and_gradients_match_the_reference(kind):
    """At the reference's initial params on one batch: the loss within
    1e-4 relative, each gradient tensor within rtol 1e-4 plus an absolute
    1e-4 of its largest entry (entries near zero carry the summation
    order's rounding). The batch stays MARGIN clear of every ReLU and
    pool decision (asserted), so rounding cannot flip one."""
    x, y = _batch(kind)
    assert min(_margins(kind, x)) > MARGIN
    want_loss, want_grads = _ref_value_and_grad(kind, x, y)
    tfwd = _forward_pair(kind)[0]
    params = _carried(kind)
    leaves = train._trainable(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.autograd.set_detect_anomaly(True):
        if kind.startswith("seg"):
            loss, _ = train.seg_loss(tfwd, params, xt, yt.long())
        else:
            loss = train.pose_loss(tfwd, params, xt, yt, 4.0, 30.0)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    got = _leaves({k: tuple(None if t is None else t.grad for t in v)
                   for k, v in params.items()} if isinstance(params, dict)
                  else [None if p is None else tuple(
                      None if t is None else t.grad for t in p)
                        for p in params])
    assert len(got) == len(want_grads) == len(leaves)
    for g, w in zip(got, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_pool_gradient_goes_to_the_first_maximum():
    """Ties inside a 2x2 window at a positive value: the reference's
    reduce_window max and the port's training pool give the whole
    gradient to the first maximum in window order; the values are the
    serving path's."""
    x = np.zeros((4, 6, 2), np.float32)
    x[0, 0:2, 0] = 1.5
    x[2:4, 2, 1] = 0.5
    x[3, 4:6, :] = 2.0
    up = np.arange(1, 13, dtype=np.float32).reshape(2, 3, 2)

    def ref(a):
        return lax.reduce_window(a, -jnp.inf, lax.max, (2, 2, 1), (2, 2, 1),
                                 "VALID")
    want = np.asarray(jax.grad(lambda a: (ref(a) * up).sum())(jnp.asarray(x)))
    spec = PoolSpec(window=(2, 2), stride=(2, 2))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = network.dense_pool(xt, spec)
    (y * torch.from_numpy(up)).sum().backward()
    assert np.array_equal(xt.grad.numpy(), want)
    with torch.no_grad():
        assert torch.equal(network.dense_pool(xt, spec), y.detach())
    assert np.array_equal(y.detach().numpy(), np.asarray(ref(jnp.asarray(x))))


# ------------------------------- (d) schedule --------------------------------


@pytest.mark.parametrize("lr,steps", [(2e-3, 7), (2e-3, 300), (1e-2, 3000)])
def test_cosine_schedule_is_optax(lr, steps):
    """The learning rate each update runs at under ``LambdaLR`` is
    ``optax.cosine_decay_schedule(lr, steps)`` at optax's update count
    (0 for the first), within float32 rounding (optax evaluates in
    float32)."""
    sched_ref = optax.cosine_decay_schedule(lr, steps)
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([p], lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, train.cosine_decay(steps))
    got, want = [], []
    for k in range(min(steps, 400)):
        got.append(opt.param_groups[0]["lr"])
        want.append(float(sched_ref(k)))
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * lr)
    assert got[0] == lr


# ---------------------------- (e) three Adam steps ---------------------------


@pytest.mark.parametrize("kind", list(CASES))
def test_three_steps_match_the_reference(runs, kind):
    ref, port = runs[kind]
    want_losses = [b[2] for b in ref["batches"]]
    np.testing.assert_allclose(port["losses"], want_losses, rtol=1e-4)
    got, want = _leaves(port["params"]), _leaves(ref["params"])
    assert [g.shape for g in got] == [w.shape for w in want]
    g, w = np.concatenate([a.ravel() for a in got]), \
        np.concatenate([a.ravel() for a in want])
    close = np.abs(g - w) <= 1e-5 + 1e-4 * np.abs(w)
    assert close.mean() >= 0.999, close.mean()
    assert np.abs(g - w).max() <= 2 * LR[kind] * STEPS
    if kind.startswith("seg"):
        # the accuracy of the last batch before its update
        assert abs(port["metric"] - ref["metric"]) <= 1.0 / (2 * 12 * 16)
    else:
        assert 0.0 <= port["metric"] <= 1.0


# ------------------------------- (f) it learns -------------------------------


@pytest.mark.parametrize("kind", ["seg", "pose", "pose_graph"])
def test_loss_falls_over_thirty_steps(kind):
    losses = _run_port(kind, steps=30, carried=False)["losses"]
    assert len(losses) == 30 and np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), losses


def test_trained_params_keep_the_layout():
    """Float32 tensors without autograd, in the reference's layout: what
    the npz writers and ``load_npz_params`` take."""
    r = _run_port("seg", steps=1, carried=False)
    specs = CASES["seg"][0]()
    assert len(r["params"]) == len(specs)
    for s, p in zip(specs, r["params"]):
        if isinstance(s, ConvSpec):
            w, b = p
            assert w.shape == (*s.kernel, w.shape[2], s.features)
            assert w.dtype == b.dtype == torch.float32
            assert not w.requires_grad and not b.requires_grad
        else:
            assert p is None
    g = _run_port("pose_graph", steps=1, carried=False)["params"]
    nodes = CASES["pose_graph"][0]()[0]
    assert set(g) == {n.name for n in nodes if isinstance(n.spec, ConvSpec)}


# ---------------------------- (g) no silent CPU ------------------------------


@pytest.mark.parametrize("kind", ["seg", "pose", "pose_graph"])
def test_entry_points_refuse_cuda_without_a_card(monkeypatch, kind):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmodel, _, shape, kw = CASES[kind]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if kind == "seg":
            train.train_segmentation(tmodel(), shape, 8, steps=1, **kw)
        elif kind == "pose":
            train.train_pose(tmodel(), shape, steps=1, **kw)
        else:
            nodes, out = tmodel()
            train.train_pose_graph(nodes, out, shape, steps=1, **kw)


def test_trainers_check_the_output_width():
    with pytest.raises(ValueError, match="classes"):
        train.train_segmentation(CASES["seg"][0](), (48, 64, 3), 5, steps=1,
                                 device="cpu")
    with pytest.raises(ValueError, match="paf"):
        train.train_pose(CASES["seg"][0](), (48, 64, 3), steps=1,
                         device="cpu")


def test_cross_entropy_is_optax_per_pixel():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    labels = rng.integers(0, 8, (2, 3, 4)).astype(np.int32)
    want = float(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels)).mean())
    got = float(F.cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                torch.from_numpy(labels).long()))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_losses_list_is_optional():
    specs = CASES["seg"][0]()
    p, acc = train.train_segmentation(specs, (48, 64, 3), 8, steps=2,
                                      batch=2, n_videos=2, device="cpu")
    assert 0.0 <= acc <= 1.0 and len(p) == len(specs)


_BLOCKED_RUN = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["optax"] = None
sys.modules["cbinfer_tpu"] = None
import torch
torch.set_num_threads(2)
import cbinfer_tpu_torch.benchmark, cbinfer_tpu_torch.train
sys.argv = ["torch_train.py", "scene", "--out", sys.argv[1], "--steps", "2",
            "--device", "cpu"]
runpy.run_path("scripts/torch_train.py", run_name="__main__")
"""


def test_train_script_writes_the_shipped_layout_without_jax(tmp_path):
    """scripts/torch_train.py (and train, benchmark) with jax, optax and
    the reference unimportable: two steps of the scene recipe on the CPU
    write an npz with the shipped checkpoint's keys and shapes, which
    load_npz_params reads."""
    import json
    import os
    import subprocess
    import sys
    from cbinfer_tpu_torch.checkpoint import load_npz_params
    from cbinfer_tpu_torch.network import init_params
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
                       cwd=repo, env={**os.environ, "PYTHONPATH": repo},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["steps"] == 2 and line["device"] == "cpu"
    assert line["card"] is None and 0.0 <= line["train_acc"] <= 1.0
    got = np.load(tmp_path / "scene_w128.npz")
    want = np.load(os.path.join(repo, "ckpts", "scene_w128.npz"))
    assert sorted(got.files) == sorted(want.files)
    assert all(got[k].shape == want[k].shape and got[k].dtype == np.float32
               for k in want.files)
    specs = get_model("scene", num_classes=8, width=128)
    like = init_params(specs, (192, 256, 3), 1, device="cpu")
    loaded = load_npz_params(str(tmp_path / "scene_w128.npz"), like, specs)
    assert np.array_equal(loaded[0][0].numpy(), got["w0"])
