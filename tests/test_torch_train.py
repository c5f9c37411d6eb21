"""The port's training half against the reference on the CPU: the train
step (loss, gradients, optimizer state) of all ten smoke configs in
float32 with AdamW and Adafactor and 1 or 2 microbatches,
``apply_updates``, ``lr_at`` and ``_global_norm`` given the reference's
inputs, the reference's own fault-tolerance tests
(``tests/test_train.py``; its int8 compression case runs in
``tests/test_torch_compression.py``) run against the port, and the
launcher's checkpoint and resume. Inputs come from numpy seeds and go
through both packages."""

import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import transformer as RT
from repro.train import optim as RO
from repro_torch import configs as TC
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optim as O
from repro_torch import tree as TR
from repro_torch.train import train_loop as TL
from repro_torch.train.elastic import (TrainState, Watchdog, reshard_restore,
                                       run_resumable)

from _torch_train_parity import (ARCHS, GRAD_BOUND, KINDS,  # noqa: F401
                                 _batch, _leaf_close, _model,
                                 _two_torch_threads, step_matches_reference)

# apply_updates from the same inputs: each op rounds as the reference's,
# but the global norm sums in another order than XLA's, so the clip scale
# and every clipped gradient move by a few ulps (twice that in g^2), and
# a difference of two terms keeps the ulps of the larger: within ULPS
# units in the last place of the larger of the result and its input
ULPS = 32


@pytest.fixture(scope="module")
def models():
    return {}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(models, arch, microbatches, kind):
    step_matches_reference(models, arch, kind, microbatches)


def test_value_and_grad_matches_jax_grad_leaf_by_leaf(models):
    """The gradients themselves, each leaf against ``jax.grad``, for a
    config with an encoder (Whisper: cross-attention's dk and dv carry
    the gradient of the encoder's output)."""
    rc, tc, rp, tp = _model(models, "whisper_base")
    batch = _batch(rc)
    rg = jax.grad(lambda p: RT.loss_fn(
        rc, p, {k: jnp.asarray(v) for k, v in batch.items()}))(rp)
    loss, tg = TL.value_and_grad(TL.make_loss(tc), tp, {
        k: torch.as_tensor(v) for k, v in batch.items()})
    for (path, got), want in zip(TR.flatten(tg), jax.tree.leaves(rg)):
        _leaf_close(got, want, GRAD_BOUND, path)
    assert float(np.abs(np.asarray(rg["encoder"]["wq"])).max()) > 0


def test_train_step_fn_picks_the_reference_optimizer():
    for arch in ARCHS:
        for smoke in (False, True):
            get_r = RC.get_smoke if smoke else RC.get_config
            get_t = TC.get_smoke if smoke else TC.get_config
            from repro.train.train_loop import train_step_fn as r_fn
            assert TL.train_step_fn(get_t(arch))[1] == O.OptConfig(
                **vars(r_fn(get_r(arch))[1]))


# ---------------------------------------------------------------------------
# apply_updates, lr_at, _global_norm
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(16, 12).astype(np.float32),
                  "b": rng.randn(12).astype(np.float32)},
            "e": rng.randn(3, 8, 5).astype(np.float32)}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_matches_reference_from_its_inputs(kind):
    """Four steps of the reference's apply_updates; before each, the port
    takes the reference's params, state and gradients (gradients of 1e-3
    to 10) and its output is held within ULPS of the reference's."""
    rng = np.random.RandomState(1)
    cfg = dict(kind=kind, lr=1e-2, warmup=2, total_steps=20)
    rcfg, tcfg = RO.OptConfig(**cfg), O.OptConfig(**cfg)
    rp = jax.tree.map(jnp.asarray, _tree())
    rs = RO.init_state(rcfg, rp)
    for _ in range(4):
        grads = jax.tree.map(lambda x: (rng.randn(*x.shape) * 10 ** rng.uniform(
            -3, 1)).astype(np.float32), _tree())
        before = TR.tree_map(lambda x: torch.as_tensor(np.array(x)),
                             {"p": rp, "s": rs})
        rp, rs = RO.apply_updates(rcfg, rp, jax.tree.map(jnp.asarray, grads),
                                  rs)
        tp, ts = O.apply_updates(tcfg, before["p"],
                                 TR.tree_map(torch.as_tensor, grads),
                                 before["s"])
        for (path, got), want, inp in zip(
                TR.flatten({"p": tp, "s": ts}),
                jax.tree.leaves({"p": rp, "s": rs}), TR.leaves(before)):
            got, want, inp = got.numpy(), np.asarray(want), inp.numpy()
            if got.dtype.kind != "f":
                assert np.array_equal(got, want), path
                continue
            ulp = np.spacing(np.maximum(np.abs(want), np.abs(inp)))
            assert bool((np.abs(got - want) <= ULPS * ulp).all()), path


def test_apply_updates_donated_equals_functional():
    cfg = O.OptConfig(kind="adamw", lr=1e-2, warmup=1, total_steps=10)
    p = TR.tree_map(torch.as_tensor, _tree())
    g = TR.tree_map(lambda t: t * 0.5, p)
    s = O.init_state(cfg, p)
    fp, fs = O.apply_updates(cfg, p, g, s)
    p2, s2 = TR.tree_map(torch.clone, p), TR.tree_map(torch.clone, s)
    dp, ds = O.apply_updates(cfg, p2, g, s2, donate=True)
    assert dp["a"]["w"] is p2["a"]["w"] and ds["m"]["e"] is s2["m"]["e"]
    for a, b in zip(TR.leaves({"p": fp, "s": fs}),
                    TR.leaves({"p": dp, "s": ds})):
        assert torch.equal(a, b)


def test_lr_at_is_the_reference_schedule_in_float32():
    for cfg in (dict(lr=3e-4, warmup=100, total_steps=10000),
                dict(lr=1e-3, warmup=1, total_steps=10),
                dict(lr=0.1, warmup=0, total_steps=5)):
        for step in (0, 1, 2, 7, 99, 100, 101, 5000, 10000, 20000):
            want = RO.lr_at(RO.OptConfig(**cfg), jnp.int32(step))
            got = O.lr_at(O.OptConfig(**cfg),
                          torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert np.asarray(want).dtype == np.float32
            assert float(got) == float(want), (cfg, step)


def test_global_norm_sums_leaves_in_sorted_key_order():
    tree = {"b": torch.tensor([3.0]), "a": torch.tensor([1e8]),
            "c": torch.tensor([4.0])}
    # leaves a, b, c: (1e16 + 9) + 16 rounds differently from any other
    # order only through the order; the sum is taken a leaf at a time
    want = np.sqrt(np.float32(np.float32(np.float32(1e16) + np.float32(9.0))
                              + np.float32(16.0)))
    assert float(O._global_norm(tree)) == float(want)
    assert float(O._global_norm(tree)) == float(RO._global_norm(
        {k: jnp.asarray(v.numpy()) for k, v in tree.items()}))


def test_abstract_state_is_on_meta_with_init_state_shapes():
    params = TR.tree_map(torch.as_tensor, _tree())
    for kind in ("adamw", "adafactor"):
        cfg = O.OptConfig(kind=kind)
        real, meta = O.init_state(cfg, params), O.abstract_state(cfg, params)
        for a, b in zip(TR.flatten(real), TR.flatten(meta)):
            assert a[0] == b[0] and a[1].shape == b[1].shape
            assert a[1].dtype == b[1].dtype and b[1].device.type == "meta"


# ---------------------------------------------------------------------------
# the reference's fault-tolerance tests (tests/test_train.py), on the port
# ---------------------------------------------------------------------------

def small_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.float32)}}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    tree = small_tree()
    CKPT.save(d, 7, tree, extra={"cursor": 3})
    got, manifest = CKPT.restore(d, template=tree)
    assert manifest["step"] == 7 and manifest["extra"]["cursor"] == 3
    np.testing.assert_array_equal(np.asarray(got["a"]),
                                  np.asarray(tree["a"]))


def test_checkpoint_atomicity_ignores_incomplete(tmp_path):
    d = str(tmp_path / "ck")
    CKPT.save(d, 1, small_tree())
    # simulate a crash mid-write of step 2: directory without .complete
    os.makedirs(os.path.join(d, "step_00000002"))
    assert CKPT.latest_step(d) == 1


def test_checkpoint_integrity_detection(tmp_path):
    d = str(tmp_path / "ck")
    CKPT.save(d, 1, small_tree())
    path = os.path.join(d, "step_00000001", "arrays.npz")
    data = dict(np.load(path))
    data["a"] = data["a"] + 1
    np.savez(path, **data)
    with pytest.raises(AssertionError, match="checksum"):
        CKPT.restore(d, template=small_tree())


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(1, 6):
        CKPT.save(d, s, small_tree(), keep_last_k=2)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    ck = CKPT.AsyncCheckpointer(d, keep_last_k=2)
    ck.save(10, small_tree())
    ck.wait()
    assert CKPT.latest_step(d) == 10


def _quadratic_step(cfg):
    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            w = params["w"].detach().requires_grad_(True)
            loss = torch.sum((w - batch) ** 2)
            g, = torch.autograd.grad(loss, [w])
        p2, s2 = O.apply_updates(cfg, params, {"w": g}, opt_state)
        return p2, s2, {"loss": loss.detach()}
    return train_step


def test_run_resumable_resumes_after_interrupt(tmp_path):
    """Train 3 steps, 'crash', restart: resumes at step 3 with state."""
    d = str(tmp_path / "ck")
    cfg = O.OptConfig(kind="adamw", lr=0.1, warmup=1, total_steps=100)
    params = {"w": torch.ones((4,), dtype=torch.float32)}

    def batch_fn(cursor, rng):
        return torch.full((4,), float(cursor % 3), dtype=torch.float32)

    st0 = TrainState(params, O.init_state(cfg, params), 0, None, 0)
    st1 = run_resumable(_quadratic_step(cfg), st0, batch_fn, n_steps=3,
                        ckpt_dir=d, ckpt_every=2)
    assert st1.step == 3
    st2 = TrainState(params, O.init_state(cfg, params), 0, None, 0)
    st2 = run_resumable(_quadratic_step(cfg), st2, batch_fn, n_steps=6,
                        ckpt_dir=d, ckpt_every=2)
    assert st2.step == 6
    assert st2.data_cursor == 6     # exact-once batch accounting


def test_run_resumable_saves_on_sigterm_and_resumes_equal(tmp_path):
    """SIGTERM during step 2 ends the loop after it with a final save; the
    resumed run's losses and parameters equal an uninterrupted run's."""
    cfg = O.OptConfig(kind="adamw", lr=0.1, warmup=1, total_steps=100)

    def batch_fn(cursor, rng):
        return torch.full((4,), float(cursor % 3), dtype=torch.float32)

    def run(d, n, kill_at=None):
        losses = []
        step = _quadratic_step(cfg)

        def logged(p, s, b):
            out = step(p, s, b)
            if kill_at is not None and int(out[1]["step"]) == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        params = {"w": torch.ones((4,), dtype=torch.float32)}
        st = TrainState(params, O.init_state(cfg, params), 0, None, 0)
        st = run_resumable(logged, st, batch_fn, n_steps=n, ckpt_dir=d,
                           ckpt_every=100,
                           log=lambda s, m: losses.append(m["loss"]))
        return st, losses

    whole, want = run(str(tmp_path / "a"), 5)
    cut, first = run(str(tmp_path / "b"), 5, kill_at=2)
    assert cut.step == 2 and CKPT.latest_step(str(tmp_path / "b")) == 2
    rest, second = run(str(tmp_path / "b"), 5)
    assert first + second == want
    assert torch.equal(rest.params["w"], whole.params["w"])


def test_watchdog_flags_stragglers():
    w = Watchdog(alpha=0.5, threshold=2.0)
    flagged = []
    w.on_straggler = lambda s, dt, ew: flagged.append(s)
    for s, dt in enumerate([1.0, 1.1, 0.9, 5.0, 1.0]):
        w.observe(s, dt)
    assert flagged == [3]
    assert w.slow_steps == 1


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_converges_quadratic(kind):
    cfg = O.OptConfig(kind=kind, lr=0.1, warmup=1, total_steps=500,
                      weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = O.init_state(cfg, params)
    target = torch.tensor([1.0, 1.0, 1.0])
    for _ in range(150):
        g = {"w": 2 * (params["w"] - target)}
        params, state = O.apply_updates(cfg, params, g, state)
    assert float(torch.max(torch.abs(params["w"] - target))) < 0.3


def test_adafactor_memory_is_factored():
    cfg = O.OptConfig(kind="adafactor")
    params = {"w": torch.zeros((64, 32))}
    st = O.init_state(cfg, params)
    assert st["f"]["w"]["vr"].shape == (64,)
    assert st["f"]["w"]["vc"].shape == (32,)


def test_elastic_reshard_restore(tmp_path):
    """A checkpoint restores onto the devices a tree names (None: the
    template leaf's)."""
    d = str(tmp_path / "ck")
    tree = small_tree()
    CKPT.save(d, 1, tree)
    got, _ = reshard_restore(d, tree, TR.tree_map(lambda _: None, tree))
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]),
                                  np.asarray(tree["b"]["c"]))
    got, _ = reshard_restore(d, tree, TR.tree_map(
        lambda _: torch.device("meta"), tree))
    assert got["a"].device.type == "meta"


def test_checkpoint_bf16_leaves_are_uint16_bits_with_their_dtype(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.randn(5, 3).to(torch.bfloat16)
    CKPT.save(d, 1, {"x": x, "s": torch.zeros((), dtype=torch.int32)})
    got, manifest = CKPT.restore(d)
    assert manifest["leaves"]["x"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(d, "step_00000001", "arrays.npz"))[
        "x"].dtype == np.uint16
    assert got["x"].dtype == torch.bfloat16 and torch.equal(
        got["x"].view(torch.int16), x.view(torch.int16))
    assert got["s"].dtype == torch.int32 and got["s"].shape == ()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_checkpoints_and_resumes(tmp_path, capsys):
    """``launch/train.py --smoke --device cpu``: 3 steps, checkpoints; a
    second run resumes at the saved step; its losses equal those of one
    uninterrupted direct ``run_resumable`` over the same steps."""
    d = str(tmp_path / "run")
    argv = ["--arch", "gemma2_27b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--docs", "32", "--ckpt", d,
            "--ckpt-every", "2"]
    first = TLAUNCH.main(argv + ["--steps", "3"])
    assert len(first) == 3 and CKPT.latest_step(d) == 3
    second = TLAUNCH.main(argv + ["--steps", "5"])
    assert len(second) == 2 and CKPT.latest_step(d) == 5
    out = capsys.readouterr().out
    assert "pipeline:" in out and "done: step=5" in out

    # the same five steps in one direct run
    from repro_torch.data.generators import gen_corpus
    from repro_torch.data.pipeline import TokenPipeline
    cfg = TC.get_smoke("gemma2_27b")
    pipe = TokenPipeline(batch=2, seq_len=16, device="cpu").build(
        gen_corpus(n_docs=32, vocab=cfg.vocab, seed=0))
    ocfg = O.OptConfig(kind="adamw", lr=3e-4, warmup=20, total_steps=5)
    params = TT.init_params(cfg, 0, device="cpu")
    losses = []
    run_resumable(TL.make_train_step(cfg, ocfg, donate=True),
                  TrainState(params, O.init_state(ocfg, params), 0, None, 0),
                  lambda c, _r: pipe.batch_at(c), n_steps=5,
                  ckpt_dir=str(tmp_path / "direct"), ckpt_every=50,
                  log=lambda s, m: losses.append(m["loss"]))
    assert first + second == losses
