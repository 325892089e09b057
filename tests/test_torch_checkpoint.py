"""The port's checkpoints against cnn_tpu's, on the CPU: the committed
``.ckpt`` and ``.model`` read as cnn_tpu reads them, a ``.ckpt`` written by
the port read by cnn_tpu's ``load_checkpoint``, the ``.model`` export, and
the restricted unpickler."""

import glob
import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import optim as j_optim
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.utils import checkpoint as jck
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.optim import make_optimizer
from cnn_tpu_torch.parallel import create_train_state, make_train_step
from cnn_tpu_torch.parallel.train_step import named_params
from cnn_tpu_torch.utils import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = glob.glob(os.path.join(REPO, "checkpoints", "alexnet_bn_fullaug_mxu",
                              "iter_8000_*.ckpt"))[0]
MODEL = CKPT[:-len(".ckpt")] + ".model"
# the committed .ckpt/.model pairs, with their steps
PAIRS = [(CKPT, 8000)] + [
    (glob.glob(os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                            f"iter_{n}_*.ckpt"))[0], n) for n in (5000, 12000)]


def _state(batch_norm=True, image_size=224, optimizer="momentum",
           schedule="cosine", seed=212):
    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      image_size=image_size, device="cpu")
    opt = make_optimizer(optimizer, 1.5e-2, schedule=schedule,
                         total_steps=100)
    return create_train_state(model, opt, seed=seed), opt


def _trees_equal(a, b) -> bool:
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    return ta == tb and all(np.array_equal(np.asarray(x), np.asarray(y))
                            for x, y in zip(la, lb))


@pytest.mark.parametrize("path,step", PAIRS)
def test_committed_ckpt_loads_bit_equal_to_cnn_tpu(path, step):
    ts, _ = _state()
    ck.load_checkpoint(path, ts)
    want = jck.load_checkpoint(path)
    params, state = ck.model_trees(ts.model)
    assert _trees_equal(params, want.params)
    assert _trees_equal(state, want.state)
    trace = ck._nest(ts.opt_state[0].trace)
    assert _trees_equal(trace, want.opt_state[0].trace)
    assert int(ts.opt_state[1].count) == int(want.opt_state[1].count) == step
    assert ts.step == int(want.step) == step
    k = np.asarray(jax.random.key_data(want.rng))
    assert ts.seed == (int(k[0]) << 32 | int(k[1]))
    # the .model beside it holds the same weights and statistics
    m_params, m_state = ck.import_reference_model(
        path[:-len(".ckpt")] + ".model", ts.model)
    assert _trees_equal(m_params, want.params)
    assert _trees_equal(m_state, want.state)


def test_committed_ckpt_logits_match_cnn_tpu():
    """On the four 224 px images of the gradient fixture."""
    ts, _ = _state()
    ck.load_checkpoint(CKPT, ts)
    want_ts = jck.load_checkpoint(CKPT)
    images = np.load(os.path.join(REPO, "tests", "fixtures",
                                  "grad_parity_bn.npz"))["images_u8"]
    x = images.astype(np.float32) / 255.0
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True)
    want, _, _ = jmodel.apply(want_ts.params, want_ts.state, jnp.asarray(x),
                              train=False)
    with torch.no_grad():
        got = ts.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("optimizer,schedule", [
    ("momentum", "cosine"), ("momentum", "constant"), ("sgd", "cosine"),
    ("sgd", "constant")])
def test_port_ckpt_loads_in_cnn_tpu(tmp_path, rng, optimizer, schedule):
    """Two steps on the port, saved; cnn_tpu reads the same trees, count,
    step and an optax state shaped as its own optimizer's."""
    ts, opt = _state(image_size=64, optimizer=optimizer, schedule=schedule)
    step = make_train_step(ts.model, opt)
    for _ in range(2):
        x = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), np.uint8))
        y = torch.from_numpy(rng.integers(0, 3, 4))
        ts, _ = step(ts, x, y)
    path = str(tmp_path / "p.ckpt")
    ck.save_checkpoint(path, ts)
    # cnn_tpu's backend keyword: "pickle" writes the same .ckpt, byte for
    # byte, which cnn_tpu reads below
    named = str(tmp_path / "named.ckpt")
    ck.save_checkpoint(named, ts, backend="pickle")
    with open(path, "rb") as f, open(named, "rb") as g:
        assert f.read() == g.read()
    got = jck.load_checkpoint(named)
    params, state = ck.model_trees(ts.model)
    assert _trees_equal(got.params, params)
    assert _trees_equal(got.state, state)
    assert int(got.step) == 2
    assert np.array_equal(np.asarray(jax.random.key_data(got.rng)),
                          np.asarray(jax.random.key_data(
                              jax.random.key(212))))
    j_opt = j_optim.make_optimizer(optimizer, 1.5e-2, schedule=schedule,
                                   total_steps=100)
    fresh = j_opt.init(jax.tree_util.tree_map(jnp.asarray, params))
    assert (jax.tree_util.tree_structure(got.opt_state)
            == jax.tree_util.tree_structure(fresh))
    if ts.opt_state and hasattr(ts.opt_state[0], "trace"):
        assert _trees_equal(got.opt_state[0].trace,
                            ck._nest(ts.opt_state[0].trace))
    if schedule != "constant":
        assert int(got.opt_state[1].count) == 2
    # and back: the port reads its own file into a fresh state, generator
    # included
    ts2, _ = _state(image_size=64, optimizer=optimizer, schedule=schedule,
                    seed=5)
    ck.load_checkpoint(path, ts2)
    assert ts2.step == 2 and ts2.seed == 212
    if schedule != "constant":
        assert int(ts2.opt_state[1].count) == 2
    for name, p in named_params(ts2.model).items():
        assert torch.equal(p, named_params(ts.model)[name]), name
    assert torch.equal(ts2.rng.get_state(), ts.rng.get_state())


def test_cnn_tpu_ckpt_seeds_the_generator_from_its_key():
    a, _ = _state()
    b, _ = _state(seed=9)
    ck.load_checkpoint(CKPT, a)
    ck.load_checkpoint(CKPT, b)
    assert a.seed == b.seed
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    want = torch.Generator().manual_seed((a.seed + 8000) % 2**64)
    assert torch.equal(a.rng.get_state(), want.get_state())


def test_export_reference_model_round_trips_byte_identical(tmp_path):
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      device="cpu")
    ck.load_reference_model(model, MODEL)
    out = str(tmp_path / "x.model")
    ck.export_reference_model(out, model)
    with open(MODEL, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()
    # the same bytes as cnn_tpu's export of the same params
    params, state = ck.model_trees(model)
    ref = str(tmp_path / "ref.model")
    jnet = j_get_model("alexnet", num_classes=3, batch_norm=True).net
    jck.export_reference_model(ref, jnet, params, state)
    with open(ref, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


def test_export_of_a_cnn_tpu_ckpt_matches_cnn_tpu(tmp_path):
    """A no-BN plain-SGD train state written by cnn_tpu, loaded by the
    port and exported: the bytes of cnn_tpu's own export."""
    from cnn_tpu.parallel.train_step import create_train_state as j_create
    jmodel = j_get_model("alexnet", num_classes=3)
    j_ts = j_create(jmodel, j_optim.make_optimizer("sgd", 1e-3),
                    jax.random.key(1))
    assert j_ts.opt_state == ()
    path = str(tmp_path / "j.ckpt")
    jck.save_checkpoint(path, j_ts)
    ts, _ = _state(batch_norm=False, optimizer="sgd", schedule="constant")
    ck.load_checkpoint(path, ts)
    out, ref = str(tmp_path / "a.model"), str(tmp_path / "b.model")
    ck.export_reference_model(out, ts.model)
    jck.export_reference_model(ref, jmodel.net, j_ts.params, j_ts.state)
    with open(ref, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


def test_save_checkpoint_refuses_cnn_tpus_orbax_store_by_name(tmp_path):
    """backend="orbax" raises NotImplementedError, says why and how to get
    a .ckpt, and writes nothing."""
    ts, _ = _state(image_size=64)
    path = tmp_path / "orbax_dir"
    with pytest.raises(NotImplementedError, match="orbax") as err:
        ck.save_checkpoint(str(path), ts, backend="orbax")
    assert str(err.value) == ck.ORBAX_REFUSED
    for words in ("never imports it", "load_checkpoint(directory)",
                  "save_checkpoint(path"):
        assert words in str(err.value)
    assert not path.exists()


def test_save_checkpoint_refuses_an_unknown_backend(tmp_path):
    ts, _ = _state(image_size=64)
    path = tmp_path / "x.ckpt"
    with pytest.raises(ValueError, match="'msgpack'"):
        ck.save_checkpoint(str(path), ts, backend="msgpack")
    assert not path.exists()


@pytest.mark.parametrize("reader", ["read_checkpoint", "load_checkpoint"])
def test_a_directory_is_refused_as_cnn_tpus_orbax_store(tmp_path, reader):
    """cnn_tpu's load_checkpoint opens a directory as an orbax store; the
    port's readers refuse it by name instead of an IsADirectoryError."""
    store = tmp_path / "iter_100"
    store.mkdir()
    (store / "checkpoint").write_bytes(b"")
    args = (str(store),) if reader == "read_checkpoint" else (
        str(store), None)
    with pytest.raises(NotImplementedError) as err:
        getattr(ck, reader)(*args)
    assert str(err.value) == f"{store}: {ck.ORBAX_REFUSED}"


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_unpickler_refuses_code(tmp_path):
    path = tmp_path / "evil.ckpt"
    path.write_bytes(pickle.dumps({"params": _Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        ck.read_checkpoint(str(path))
    blob = pickle.dumps({"x": np.ones(3, np.float32)})
    assert np.array_equal(ck._RestrictedUnpickler(io.BytesIO(blob)).load()
                          ["x"], np.ones(3, np.float32))


def test_checkpoint_names_and_bn_detection():
    name = ck.checkpoint_name(8000, 0.9704, 0.95)
    assert name == jck.checkpoint_name(8000, 0.9704, 0.95)
    assert ck.parse_checkpoint_name(name) == jck.parse_checkpoint_name(name)
    assert ck.parse_checkpoint_name("history.jsonl") is None
    payload = ck.read_checkpoint(CKPT)
    assert ck.tree_has_bn(payload["params"])
    assert not ck.tree_has_bn({"conv_layer_1": {"w": 0, "b": 0}})
