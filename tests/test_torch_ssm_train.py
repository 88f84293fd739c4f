"""SSM training: the scan's autograd Function (``SSMScan``: forward through
``ssm_scan``, backward through autograd of ``ssm_scan_chunked``) and
falcon-mamba's train step, against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed; model parameters are the JAX
``init`` params carried across by ``models/convert.py::params_from_jax``
(float32, the reduced widths: d_model 64, d_inner 128, N 8, 2 layers).
Tolerances, stated once:

- ``associative_scan``'s decay products bit-equal to
  ``jax.lax.associative_scan``'s (the same products in the same order);
  its states and ``ssm_scan_chunked``'s y within 1e-5 + 1e-5 * |JAX| of
  the JAX package's ``_assoc_scan_fused`` (XLA fuses the combine's
  multiply and add; the port rounds twice);
- ``SSMScan``'s gradients bit-equal to autograd of ``ssm_scan_chunked``,
  and within 1e-5 of each gradient's largest magnitude of autograd of the
  sequential ``ssm_scan_ref``;
- gradients and one train step within 1e-5 of each leaf's largest
  magnitude of the JAX package's; 10-step losses within 1e-4 relative (as
  ``test_torch_train.py``).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.distributed.steps import make_train_step as jax_make_train_step
from repro.launch.mesh import make_local_mesh
from repro.models import get_model as jax_get_model
from repro.models import ssm as JS
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import ParallelConfig, ShapeConfig, get_config, reduced
from repro_torch.distributed.steps import make_train_step
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import get_model
from repro_torch.models import ssm as TS
from repro_torch.models.convert import jax_tree, params_from_jax, params_to_jax
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer

SSM = "falcon-mamba-7b"


def _scan_inputs(b, s, d, n, seed=0, dtype=np.float32):
    """dt = softplus(normal), A = -exp(0.3 normal), Bm, Cm column slices of
    one (B, S, 4 + 2N) tensor as the model's ``x_db`` gives them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal((d, n))).astype(np.float32)
    x_db = torch.from_numpy(rng.standard_normal((b, s, 4 + 2 * n)).astype(
        np.float32)).to(torch.float32 if dtype == np.float32 else
                        torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(
        np.float32)).to(x_db.dtype)
    _, Bm, Cm = x_db.split([4, n, n], dim=-1)
    return torch.from_numpy(dt), torch.from_numpy(A), Bm, Cm, x


def _jax_fused(dt, A, Bm, Cm, x, chunk):
    """The JAX package's Mamba1 scan: ``_mamba1_ssm_inputs``' decay and
    input, ``_assoc_scan_fused`` with the C contraction."""
    a = jnp.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    h0 = jnp.zeros((dt.shape[0],) + A.shape, jnp.float32)
    y, _ = JS._assoc_scan_fused(
        a, b, h0, Cm, chunk,
        lambda hc, cc: jnp.einsum("bscn,bsn->bsc", hc, cc,
                                  preferred_element_type=jnp.float32))
    return y


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 7, 8, 33, 128])
def test_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 5, 3)).astype(np.float32)

    def combine(left, right):
        return right[0] * left[0], right[0] * left[1] + right[1]
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    ta, tb = ops.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(300, 128), (300, 100), (64, 8),
                                     (5, 128)])
def test_ssm_scan_chunked_matches_jax_assoc_scan_fused(s, chunk):
    """At the JAX chunk (the largest divisor of S up to ``chunk``: 100 for
    300 and 128) and at the port's ragged chunks of 128."""
    dt, A, Bm, Cm, x = _scan_inputs(2, s, 16, 8, seed=s)
    want = jax.jit(_jax_fused, static_argnums=5)(
        *(jnp.asarray(t.numpy()) for t in (dt, A, Bm, Cm, x)), chunk)
    got = ops.ssm_scan_chunked(dt, A, Bm, Cm, x, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ops.ssm_scan_plain(
        dt, A, Bm, Cm, x).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("s", [1, 37, 300])
def test_ssm_scan_function_gradients(s, dtype):
    """``SSMScan`` (forward through the wrapper: its plain version on the
    CPU): its output is the plain version's, its gradients are autograd's
    of ``ssm_scan_chunked`` bit for bit, in each input's dtype, and those
    of the sequential oracle within 1e-5 of each gradient's largest
    magnitude; an input that asks for none gets none."""
    args = _scan_inputs(2, s, 12, 4, seed=s, dtype=dtype)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, s, 12)).astype(np.float32))

    def leaves():
        return [t.detach().clone().requires_grad_() for t in args]
    ins = leaves()
    y = ops.SSMScan.apply(*ins)
    assert torch.equal(y, ops.ssm_scan_plain(*args))
    got = torch.autograd.grad(y, ins, g)
    ref = leaves()
    want = torch.autograd.grad(ops.ssm_scan_chunked(*ref), ref, g)
    assert all(a.dtype == t.dtype and torch.equal(a, b)
               for a, b, t in zip(got, want, args))
    seq = leaves()
    oracle = torch.autograd.grad(ssm_scan_ref(*seq), seq, g)
    if dtype == np.float32:
        for a, b in zip(got, oracle):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    x_only = [t.detach() for t in args[:4]] + [args[4].detach()
                                               .requires_grad_()]
    (gx,) = torch.autograd.grad(ops.SSMScan.apply(*x_only), (x_only[4],), g)
    assert torch.equal(gx, want[4])


def test_ssm_scan_chunked_checkpoints_each_chunk():
    """Under autograd each chunk runs under torch.utils.checkpoint, so the
    forward keeps no (B, chunk, D, N) tensor: the graph's saved tensors are
    the chunks' inputs, not their decay and state histories."""
    dt, A, Bm, Cm, x = (t.requires_grad_() for t in _scan_inputs(
        1, 256, 32, 8))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ops.ssm_scan_chunked(dt, A, Bm, Cm, x, chunk=64)
    assert max(saved) < 64 * 32 * 8      # less than one chunk's decay


# ---------------------------------------------------------------------------
# falcon-mamba's training against the JAX package's
# ---------------------------------------------------------------------------
def _configs(n_layers=2):
    return (dataclasses.replace(jreduced(jget(SSM)), n_layers=n_layers),
            dataclasses.replace(reduced(get_config(SSM)), n_layers=n_layers))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _configs()
    params = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    return params, jax.tree.map(np.asarray, params)


def _batch(vocab, b=4, s=32, seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                               dtype=np.int32)
    return {"tokens": tok, "labels": tok}


def _close_per_leaf(port: dict, ref: dict, tol=1e-5):
    pf = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    rf = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert set(pf) == set(rf)
    for path, r in rf.items():
        p = pf[path]
        p = p.detach().numpy() if isinstance(p, torch.Tensor) else \
            np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, path
        assert np.abs(p - r).max() <= tol * np.abs(r).max(), path


def test_mamba_gradients_match_jax():
    """``jax.grad`` of the JAX Mamba1 loss (its chunked associative scan)
    against the port's backward through ``SSMScan``: every leaf, A_log, D
    and dt_bias included."""
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    batch = _batch(jcfg.vocab_size)
    jgrads = jax.jit(jax.grad(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, batch)))(params)
    model = params_from_jax(host, tcfg, "cpu").requires_grad_()
    get_model(tcfg).loss_fn(model, tcfg, {
        k: torch.from_numpy(v) for k, v in batch.items()}).backward()
    port = jax_tree({k: p.grad for k, p in model.named_parameters()}, tcfg)
    _close_per_leaf(port, jax.tree.map(np.asarray, jgrads))


def test_mamba_train_step_matches_jax():
    """One step of each package's train step at the reference's default
    optimizer settings: loss, grad norm and every leaf after the update."""
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    batch = _batch(jcfg.vocab_size)
    with make_local_mesh(1, 1) as mesh:
        jb = jax_make_train_step(jcfg, mesh, JParallel(),
                                 JShape("t", "train", 32, 4))
        jnew, _, jm = jb.fn(params, jopt.adamw_init(params), dict(batch))
    model = params_from_jax(host, tcfg, "cpu").requires_grad_()
    state = opt.adamw_init(dict(model.named_parameters()))
    tb = make_train_step(tcfg, ParallelConfig(),
                         ShapeConfig("t", "train", 32, 4))
    _, _, tm = tb.fn(model, state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    _close_per_leaf(params_to_jax(model), jax.tree.map(np.asarray, jnew))


def test_mamba_ten_step_losses_match_jax():
    jcfg, tcfg = _configs()
    _, host = _jax_params()
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=10)
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                  JShape("t", "train", 32, 4), jopt.OptimizerConfig(**kw))
    _, jl = jt.fit(jdata.SyntheticCorpus(jcfg.vocab_size, 0).batches(4, 32,
                                                                      10),
                   10, state=jt.init_state(), log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", 32, 4),
                 opt.OptimizerConfig(**kw), device="cpu")
    _, tl = tt.fit(tdata.SyntheticCorpus(tcfg.vocab_size, 0).batches(4, 32,
                                                                      10),
                   10, state=tt.state_from_jax(host), log_every=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("mode", ["none", "nothing", "dots"])
def test_mamba_remat_changes_no_number_and_runs_the_scan_again(mode):
    """cfg.remat wraps each Mamba layer in torch.utils.checkpoint as
    ``remat_mode`` says: the same loss and gradients bit for bit; under
    "nothing" and "dots" the recomputed forward runs the scan's forward
    once more a layer (so on the card, the kernel twice a layer a step),
    under "none" it does not."""
    _, tcfg = _configs()
    (want, base), (grads, calls) = (_remat_step(False, "none"),
                                    _remat_step(True, mode))
    assert all(torch.equal(a, b) for a, b in zip(want, grads))
    assert [base, calls] == [tcfg.n_layers,
                             (1 if mode == "none" else 2) * tcfg.n_layers]


@functools.lru_cache(maxsize=None)
def _remat_step(remat: bool, mode: str) -> tuple:
    """(loss and gradients, scan calls) of one step under ``cfg.remat``
    and ``remat_mode`` (kept: each case compares with the same remat=False
    run)."""
    _, tcfg = _configs()
    _, host = _jax_params()
    cfg = dataclasses.replace(tcfg, remat=remat, remat_mode=mode)
    model = params_from_jax(host, cfg, "cpu").requires_grad_()
    n, orig = [0], ops.ssm_scan

    def counting(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "ssm_scan", counting)
        loss = get_model(cfg).loss_fn(model, cfg, {
            k: torch.from_numpy(v) for k, v in
            _batch(tcfg.vocab_size).items()})
        loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()], n[0]


def test_mamba1_apply_takes_the_function_only_under_autograd():
    """Serving (no gradient recorded) calls the wrapper directly, as before;
    a forward that records gradients goes through ``SSMScan``; a prefill
    asking for the final state calls the wrapper directly."""
    _, tcfg = _configs()
    _, host = _jax_params()
    lp = params_from_jax(host, tcfg, "cpu").layers[0]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 9, tcfg.d_model)).astype(np.float32))
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "ssm_scan", lambda *a, **kw: seen.append("wrapper")
                   or ops.ssm_scan(*a, **kw))
        mp.setattr(TS, "SSMScan", types.SimpleNamespace(
            apply=lambda *a: seen.append("function")
            or ops.SSMScan.apply(*a)))
        with torch.no_grad():
            TS.mamba1_apply(lp, x, tcfg)
        TS.mamba1_apply(lp, x, tcfg)
        TS.mamba1_apply(lp, x, tcfg, return_state=True)
    assert seen == ["wrapper", "function", "wrapper"]
