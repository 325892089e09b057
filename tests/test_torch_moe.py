"""The MoE block and MoECNN against ``cnn_tpu`` on the CPU (seed 19 for every
numpy draw unless a test names another): the block's output, routing,
capacity overflow, gradients, balance loss and load, in float32 and bf16;
MoECNN's logits, a training step's gradients and new state against
``jax.value_and_grad(_loss_fn)``, and one train step with an EMA against
``cnn_tpu``'s; the committed MoECNN checkpoints through the ``.ckpt``
reader and writer; the train, infer, evaluate and Grad-CAM CLIs on
MoECNN.

Routing is an argmax: a token whose two best router logits lie within
float32 reassociation of each other would route differently in another
sum order. Each test's inputs have a top-2 router probability gap above
1e-4 (asserted), so the routes must agree exactly."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import optim as j_optim
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.nn.moe import MoEBlock as JMoEBlock
from cnn_tpu.parallel import make_train_step as j_make_train_step
from cnn_tpu.parallel.train_step import TrainState as JTrainState
from cnn_tpu.parallel.train_step import _loss_fn as j_loss_fn
from cnn_tpu.tools import evaluate as j_evaluate
from cnn_tpu.tools import gradcam as j_gradcam
from cnn_tpu.tools import infer as j_infer
from cnn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from cnn_tpu_torch import optim
from cnn_tpu_torch.models import MoECNN, get_model
from cnn_tpu_torch.nn import MoEBlock
from cnn_tpu_torch.parallel import create_train_state, make_train_step
from cnn_tpu_torch.parallel.train_step import (loss_fn, named_params,
                                               named_state)
from cnn_tpu_torch.tools import evaluate, gradcam, infer, train
from cnn_tpu_torch.utils import checkpoint as ckpt
from cnn_tpu_torch.utils.history import read_history
from test_torch_data import write_dataset
from test_torch_evaluate_cli import _parse as parse_metrics
from test_torch_evaluate_cli import ppm_dataset  # noqa: F401
from test_torch_family_cli import _at, _leaves
from test_torch_infer_cli import _parse as parse_infer
from test_torch_infer_cli import photo_paths  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 19
OUT_TOL = 1e-5        # the block's output, times max(1, max|ref|)
GRAD_TOL = 1e-5       # the block's gradients, relative to max|ref|
STATE_TOL = 1e-6      # aux_loss, its gradient, load
BF16_TOL = 5e-2       # bf16, times max(1, max|ref|) (PERF.md §2)
MODEL_TOL = 1e-4      # MoECNN's logits and gradients, times max(1, max|ref|)
TINY = dict(num_classes=3, width=16, n_experts=4, expert_hidden=32,
            image_size=32)


def _ckpt(name):
    return sorted(glob.glob(os.path.join(REPO, "checkpoints", name,
                                         "iter_*.ckpt")))[-1]


def _scaled(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


def _gap(probs) -> float:
    """The least gap between a token's two best router probabilities."""
    top2 = np.sort(np.asarray(probs), axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def _block_params(rng, d=16, h=32, e=4):
    return {"router": rng.standard_normal((d, e)).astype(np.float32),
            "w1": (rng.standard_normal((e, d, h)) * d ** -0.5).astype(
                np.float32),
            "b1": (rng.standard_normal((e, h)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((e, h, d)) * 0.2).astype(np.float32),
            "b2": (rng.standard_normal((e, d)) * 0.1).astype(np.float32)}


def _blocks(params, coeff=0.01, cap=2.0):
    jb = JMoEBlock("moe", dim=16, hidden=32, n_experts=4,
                   capacity_factor=cap, balance_coeff=coeff)
    tb = MoEBlock("moe", dim=16, hidden=32, n_experts=4,
                  capacity_factor=cap, balance_coeff=coeff, device="cpu")
    state = {"load": np.full((4,), 0.25, np.float32)}
    if coeff > 0:
        state["aux_loss"] = np.zeros((), np.float32)
    ckpt.load_jax_params(tb, params, state)
    return jb, tb, state


def test_moe_block_matches_cnn_tpu():
    """dim 16, hidden 32, 4 experts, 24 tokens, capacity 12, balance 0.01,
    training mode: output within 1e-5 x max(1, max|ref|), every token's
    expert the same, the loss ``sum(y * r) + aux_loss``'s gradients for
    every parameter and x within 1e-5 of max|ref|, aux_loss, its router
    gradient and load within 1e-6."""
    rng = np.random.default_rng(SEED)
    params = _block_params(rng)
    x = rng.standard_normal((24, 16)).astype(np.float32)
    r = rng.standard_normal((24, 16)).astype(np.float32)
    jb, tb, state = _blocks(params)
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1)
    assert _gap(probs) > 1e-4

    def j_obj(p, xx):
        y, ns = jb.apply(p, state, xx, train=True)
        return jnp.sum(y * r) + ns["aux_loss"], (y, ns)

    @jax.jit
    def j_all(p, xx):
        aux_grad = jax.grad(lambda q: jb.apply(q, state, xx, train=True)[1][
            "aux_loss"])(p)["router"]
        return jax.value_and_grad(j_obj, argnums=(0, 1),
                                  has_aux=True)(p, xx), aux_grad

    ((_, (want, ns)), (jg, jgx)), j_aux_grad = j_all(params,
                                                     jnp.asarray(x))

    tb.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tb(xt)
    obj = (y * torch.from_numpy(r)).sum() + tb.aux
    assert _scaled(y.detach(), want) <= OUT_TOL
    names = ["router", "w1", "b1", "w2", "b2"]
    grads = torch.autograd.grad(obj, [getattr(tb, n) for n in names] + [xt],
                                retain_graph=True)
    for n, g in zip(names + ["x"], grads):
        ref = np.asarray(jgx if n == "x" else jg[n], np.float64)
        assert np.abs(g.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max(), n
    (aux_grad,) = torch.autograd.grad(tb.aux, tb.router)
    assert np.abs(aux_grad.numpy() - j_aux_grad).max() <= STATE_TOL
    assert abs(float(tb.aux_loss) - float(ns["aux_loss"])) <= STATE_TOL
    assert np.abs(tb.load.numpy() - ns["load"]).max() <= STATE_TOL
    t_top = torch.softmax(torch.from_numpy(x) @ tb.router.detach(),
                          -1).argmax(-1).numpy()
    assert np.array_equal(t_top, np.asarray(probs.argmax(-1)))


def test_moe_eval_leaves_state_and_aux():
    """Eval mode: ``cnn_tpu`` returns the state unchanged; the port writes
    nothing and leaves no auxiliary term."""
    rng = np.random.default_rng(SEED)
    jb, tb, state = _blocks(_block_params(rng))
    x = rng.standard_normal((8, 16)).astype(np.float32)
    want, ns = jb.apply(_block_params(np.random.default_rng(SEED)), state,
                        jnp.asarray(x), train=False)
    tb.eval()
    with torch.no_grad():
        y = tb(torch.from_numpy(x))
    assert ns is state and tb.aux is None
    assert np.array_equal(tb.load.numpy(), state["load"])
    assert float(tb.aux_loss) == 0.0
    assert _scaled(y, want) <= OUT_TOL


def test_moe_capacity_overflow_falls_through_residual():
    """Every token routed to expert 0 with capacity 2 (factor 1, 8 tokens,
    4 experts): tokens 2..7 come out exactly x, tokens 0..1 transformed,
    as ``cnn_tpu``'s."""
    rng = np.random.default_rng(SEED)
    params = _block_params(rng)
    params["router"] = np.zeros((16, 4), np.float32)
    params["router"][:, 0] = 100.0
    jb, tb, state = _blocks(params, coeff=0.0, cap=1.0)
    x = rng.uniform(0, 1, (8, 16)).astype(np.float32)
    want, _ = jb.apply(params, state, jnp.asarray(x), train=True)
    tb.train()
    with torch.no_grad():
        y = tb(torch.from_numpy(x)).numpy()
    delta = np.abs(y - x).max(axis=1)
    assert tb.capacity(8) == 2
    assert (delta[:2] > 0).all()
    assert np.array_equal(y[2:], x[2:])
    assert np.array_equal(tb.load.numpy(), [1.0, 0.0, 0.0, 0.0])
    assert _scaled(y, want) <= OUT_TOL


def test_moe_bf16_matches_cnn_tpu():
    """``compute_dtype`` bf16 (the products in bf16, dispatch and combine
    cast to it) against ``cnn_tpu``'s: within 5e-2 x max(1, max|ref|)."""
    rng = np.random.default_rng(SEED)
    params = _block_params(rng)
    jb, tb, state = _blocks(params)
    x = rng.standard_normal((24, 16)).astype(np.float32)
    want, _ = jb.apply(params, state, jnp.asarray(x, jnp.bfloat16),
                       train=False, compute_dtype=jnp.bfloat16)
    tb.eval()
    with torch.no_grad():
        y = tb(torch.from_numpy(x).to(torch.bfloat16),
               compute_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert _scaled(y.float(), np.asarray(want, np.float32)) <= BF16_TOL


def _tiny_weights(rng, coeff):
    """``cnn_tpu``'s tiny MoECNN and its trees drawn by numpy in the
    shapes of its ``init``."""
    jm = j_get_model("moecnn", balance_coeff=coeff, **TINY)
    params, state = jax.eval_shape(jm.init, jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        params)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    return jm, params, state


def test_moecnn_logits_and_step_match_cnn_tpu():
    """MoECNN at 32 px, width 16, 4 experts, balance 0.01, 8 images:
    eval logits, and one training step's loss (CE + aux), gradients of
    every parameter, BN statistics, load and aux_loss, against
    ``jax.value_and_grad(_loss_fn)``: 1e-4 x max(1, max|ref|)."""
    rng = np.random.default_rng(SEED)
    jm, params, state = _tiny_weights(rng, 0.01)
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    labels = np.arange(8) % 3
    model = get_model("moecnn", balance_coeff=0.01, device="cpu", **TINY)
    assert isinstance(model, MoECNN)
    assert [l.name for l in model.net] == [l.name for l in jm.layers]
    ckpt.load_jax_params(model, params, state)

    want, _, _ = jm.apply(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert _scaled(got, want) <= MODEL_TOL

    (jl, (new_state, _)), jg = jax.jit(
        jax.value_and_grad(j_loss_fn, has_aux=True),
        static_argnums=(2, 6, 7))(params, state, jm, jnp.asarray(x),
                                  jnp.asarray(labels), jax.random.key(0),
                                  True, None)
    model.train()
    loss, _ = loss_fn(model, torch.from_numpy(x), torch.from_numpy(labels))
    tp = named_params(model)
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    assert abs(float(loss.detach()) - float(jl)) <= MODEL_TOL
    jflat = {ckpt.leaf_name(tuple(k.key for k in path)): v for path, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert sorted(jflat) == sorted(grads)
    for name, g in grads.items():
        assert _scaled(g, jflat[name]) <= MODEL_TOL, name
    sflat = {ckpt.leaf_name(tuple(k.key for k in path)): v for path, v in
             jax.tree_util.tree_flatten_with_path(new_state)[0]}
    assert sorted(sflat) == sorted(named_state(model))
    for name, t in named_state(model).items():
        assert _scaled(t, sflat[name]) <= MODEL_TOL, name
    assert np.abs(model.net["moe"].load.numpy()
                  - new_state["moe"]["load"]).max() <= STATE_TOL
    with torch.no_grad():
        _, feats = model(torch.from_numpy(x), capture=("gap",))
        assert _gap(torch.softmax(feats["gap"] @ model.net["moe"].router,
                                  -1)) > 1e-4


def test_moecnn_ema_train_step_matches_cnn_tpu():
    """One train step of MoECNN (balance 0.01) with momentum SGD under a
    0.9 EMA, uint8 images: the params, and the EMA'd model state (BN's,
    ``moe.load`` and ``moe.aux_loss`` among it) within 1e-4 x max(1,
    max|ref|) of ``cnn_tpu``'s train step."""
    rng = np.random.default_rng(SEED + 1)
    jm, params, state = _tiny_weights(rng, 0.01)
    x = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = np.arange(8) % 3
    j_opt = j_optim.with_ema(j_optim.make_optimizer("momentum", 0.05, 0.9),
                             0.9)
    opt_state = j_optim.ema_update_state(j_opt.init(params), state)
    jts = JTrainState(params, state, opt_state, jnp.zeros((), jnp.int32),
                      jax.random.key(0))
    jts, _ = j_make_train_step(jm, j_opt, donate=False)(
        jts, jnp.asarray(x), jnp.asarray(labels))

    model = get_model("moecnn", balance_coeff=0.01, device="cpu", **TINY)
    ckpt.load_jax_params(model, params, state)
    opt = optim.with_ema(optim.make_optimizer("momentum", 0.05, 0.9), 0.9)
    ts = create_train_state(model, opt)
    ts, _ = make_train_step(model, opt)(ts, torch.from_numpy(x),
                                        torch.from_numpy(labels))
    want = {ckpt.leaf_name(tuple(k.key for k in path)): v for path, v in
            jax.tree_util.tree_flatten_with_path(jts.opt_state.mstate)[0]}
    mstate = ts.opt_state.mstate
    assert {"moe.load", "moe.aux_loss"} <= set(mstate)
    assert sorted(mstate) == sorted(want)
    for name, t in mstate.items():
        assert _scaled(t, want[name]) <= MODEL_TOL, name
    for name, t in named_params(model).items():
        path = ckpt.leaf_path(name)
        ref = jts.params
        for key in path:
            ref = ref[key]
        assert _scaled(t.detach(), ref) <= MODEL_TOL, name


@pytest.mark.parametrize("name", ["moecnn", "moecnn_balance_0.0",
                                  "moecnn_balance_0.01"])
def test_committed_moecnn_round_trips(tmp_path, name):
    """Each committed MoECNN checkpoint (width 64, 8 experts, hidden 256,
    BN) loads into the port's train state (``aux_loss`` where the run had
    a balance loss) and ``save_checkpoint`` writes it back: params, state
    and the momentum trace equal, read by the port and by ``cnn_tpu``."""
    src = ckpt.read_checkpoint(_ckpt(name))
    coeff = 0.01 if "aux_loss" in src["state"]["moe"] else 0.0
    assert (coeff > 0) == name.endswith("0.01")
    model = get_model("moecnn", num_classes=3, balance_coeff=coeff,
                      device="cpu")
    ts = ckpt.load_checkpoint(_ckpt(name), create_train_state(
        model, optim.make_optimizer("momentum", 1.5e-2, schedule="cosine",
                                    total_steps=20000)))
    assert tuple(model.net["moe"].w1.shape) == (8, 64, 256)
    out = str(tmp_path / "again.ckpt")
    ckpt.save_checkpoint(out, ts)
    got = ckpt.read_checkpoint(out)
    back = j_load_checkpoint(out)
    for key in ("params", "state"):
        assert sorted(got[key]["moe"]) == sorted(src[key]["moe"])
        for path, v in _leaves(src[key]):
            assert np.array_equal(_at(got[key], path), v), path
            assert np.array_equal(np.asarray(_at(getattr(back, key), path)),
                                  v), path
    for path, v in _leaves(src["opt_state"][0].trace):
        assert np.array_equal(_at(got["opt_state"][0].trace, path), v)
    assert int(back.step) == ts.step == src["step"]


def test_train_cli_moecnn_logs_the_load(tmp_path, capsys):
    """``--name moecnn --moe-balance 0.01`` for 2 iterations at 64 px:
    ``MoE load [moe]: [...]`` at the validation, ``moe_load`` in the
    history record (eight fractions summing to 1), and the checkpoint's
    state holds ``aux_loss`` and loads in ``cnn_tpu``."""
    data = write_dataset(tmp_path / "data", per_class=6)
    argv = ["--dataset-path", data, "--checkpoint-dir", str(tmp_path / "ck"),
            "--image-size", "64", "--train-batch-size", "8",
            "--valid-batch-size", "8", "--valid-iters", "2",
            "--save-iters", "2", "--augment", "false", "--batch-norm",
            "true", "--backend", "python", "--num-workers", "2",
            "--total-iters", "2", "--name", "moecnn", "--moe-balance",
            "0.01"]
    assert train.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("MoE load [moe]: ")]
    assert len(line) == 1
    (rec,) = read_history(str(tmp_path / "ck" / "history.jsonl"))
    load = rec["moe_load"]["moe"]
    assert line[0] == f"MoE load [moe]: {load}"
    assert len(load) == 8 and abs(sum(load) - 1.0) <= 1e-3
    (path,) = glob.glob(str(tmp_path / "ck" / "iter_2_*.ckpt"))
    assert "aux_loss" in ckpt.read_checkpoint(path)["state"]["moe"]
    assert float(j_load_checkpoint(path).state["moe"]["aux_loss"]) > 0.0


def test_infer_cli_on_moecnn_matches_cnn_tpu(photo_paths, capsys):  # noqa: F811
    """``infer --model moecnn`` on the committed checkpoint at 64 px: the
    same classes, probabilities within 1e-5 and the same other lines."""
    argv = ["--checkpoint", _ckpt("moecnn"), "--model", "moecnn",
            "--batch-norm", "--image-size", "64", *photo_paths[:6]]
    capsys.readouterr()
    assert j_infer.main(argv) == 0
    want, want_other = parse_infer(capsys.readouterr().out)
    assert infer.main(argv, device="cpu") == 0
    got, got_other = parse_infer(capsys.readouterr().out)
    assert len(got) == 6 and [r[:2] for r in got] == [r[:2] for r in want]
    assert all(abs(g[2] - w[2]) <= 1e-5 for g, w in zip(got, want))
    assert got_other == want_other


def test_gradcam_on_moecnn_matches_cnn_tpu(photo_paths, tmp_path,  # noqa: F811
                                           capsys):
    """Grad-CAM at ``stem_relu4`` of the tiny MoECNN (numpy-drawn weights)
    on a seeded 64 px image, both modes: CAM and probabilities within 1e-4
    of ``cnn_tpu``'s ``compute_cam``; the CLI with ``--model moecnn`` on
    the committed checkpoint prints the class and writes the PNG."""
    rng = np.random.default_rng(SEED)
    jm, params, state = _tiny_weights(rng, 0.0)
    model = get_model("moecnn", device="cpu", **TINY)
    ckpt.load_jax_params(model, params, state)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    for mode in ("gradcam", "reference"):
        want_cam, want_p = j_gradcam.compute_cam(
            jm, params, state, jnp.asarray(x), "stem_relu4", mode)
        cam, probs = gradcam.compute_cam(model, torch.from_numpy(x),
                                         "stem_relu4", mode)
        assert cam.shape == want_cam.shape == (4, 4)
        assert np.abs(cam - want_cam).max() <= 1e-4
        assert np.abs(probs - want_p).max() <= 1e-4
    assert gradcam.main([photo_paths[1], "--model", "moecnn", "--batch-norm",
                         "--checkpoint", _ckpt("moecnn"), "--layer",
                         "stem_relu4", "--image-size", "64",
                         "--output-dir", str(tmp_path)], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[classification: " in out
    assert os.path.exists(tmp_path / "0.png")


def test_evaluate_cli_on_moecnn_matches_cnn_tpu(ppm_dataset, capsys):  # noqa: F811
    """``evaluate --name moecnn`` on the committed checkpoint at 64 px,
    the test split: the same lines (the confusion matrix among them), the
    printed loss within 1e-3 and the accuracy equal."""
    argv = ["--dataset-path", ppm_dataset, "--image-size", "64",
            "--valid-batch-size", "8", "--backend", "python",
            "--num-workers", "2", "--split", "test", "--resume",
            _ckpt("moecnn"), "--name", "moecnn"]
    capsys.readouterr()
    assert j_evaluate.main(argv) == 0
    want = parse_metrics(capsys.readouterr().out)
    assert evaluate.main(argv, device="cpu") == 0
    got = parse_metrics(capsys.readouterr().out)
    assert got[1] == want[1] and len(got[0]) == len(want[0]) == 1
    g, w = got[0][0], want[0][0]
    assert g[0] == w[0] and g[2] == w[2] and abs(g[1] - w[1]) <= 1e-3 + 1e-9
