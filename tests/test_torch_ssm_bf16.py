"""``ssm_scan_dtype = "bfloat16"``: the scan's bf16-state mode against the
JAX package's, on the CPU.

The JAX knob computes the decay ``a`` and the input ``b`` in f32, casts
both to bf16, scans from a bf16 zero state and contracts with ``Cm`` cast
to bf16, summing in f32 (``src/repro/models/ssm.py``).  Held here:

* the plain version (what CPU tensors take through ``ssm_scan``, and what
  the kernel is held to on the card) against the JAX package's sequential
  oracle ``reference_scan`` run in bf16: every state bit for bit;
* ``ssm_scan_chunked`` at bf16 (the function ``SSMScan``'s backward
  differentiates) against the JAX ``_assoc_scan_chunked`` at bf16, chunks
  8, 128 and 1024 with an S that none divides: every state bit for bit;
* ``SSMScan``'s bf16 gradients against ``jax.grad`` through the JAX bf16
  scan, within 1.5e-2 of each input's largest gradient (measured: 4.4e-3).
  The gradients are bf16 sums: torch sums a reduction in f32 and rounds
  once, where XLA's CPU backend splits it into windows of 32 and rounds
  to bf16 after every add, so the two differ by bf16 ulps.

A state is read through y with C one-hot in a state: y is then that state
exactly (one bf16 value times 1, plus zeros).  The bit-for-bit checks give
the JAX scans the decay and input the port computes (``_ab``): XLA's CPU
``exp`` and torch's differ by an f32 ulp on some values, which can move a
bf16 decay and so a state by ulps; the scans themselves then agree bit
for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS

from repro_torch.kernels.ssm_scan import ops

BF16 = torch.bfloat16
GRAD_TOL = 1.5e-2           # of each input's largest |gradient|


def _inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, d)))) * 0.3) \
        .astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal((d, n))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return dt, A, Bm, Cm, x


def _jax_ab(dt, A, Bm, x):
    """The JAX Mamba1's decay and input in f32, cast to bf16."""
    a = jnp.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    return a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)


def _ab(dt, A, Bm, x):
    """The same, computed by torch as the port's scans compute them, as
    JAX bf16 arrays."""
    dt, A, Bm, x = map(torch.from_numpy, (dt, A, Bm, x))
    a = torch.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    return (jnp.asarray(a.numpy()).astype(jnp.bfloat16),
            jnp.asarray(b.numpy()).astype(jnp.bfloat16))


def _one_hot(cm, k):
    out = np.zeros_like(cm)
    out[..., k] = 1
    return torch.from_numpy(out)


def _states(scan, dt, A, Bm, Cm, x):
    """Every state (B, S, D, N) of ``scan`` (a function returning y), each
    state read through y with C one-hot in it."""
    t = [torch.from_numpy(v) for v in (dt, A, Bm, x)]
    return torch.stack([scan(t[0], t[1], t[2], _one_hot(Cm, k), t[3])
                        for k in range(A.shape[1])], dim=-1)


def test_plain_bf16_state_equals_jax_reference_scan_bit_for_bit():
    dt, A, Bm, Cm, x = _inputs(2, 300, 6, 4, 0)
    a, b = _ab(dt, A, Bm, x)
    want = np.asarray(jax.jit(JS.reference_scan)(
        a, b, jnp.zeros((2, 6, 4), jnp.bfloat16)).astype(jnp.float32))
    got = _states(lambda *t: ops.ssm_scan_plain(*t, state_dtype=BF16),
                  dt, A, Bm, Cm, x)
    np.testing.assert_array_equal(got.numpy(), want)
    y, h = ops.ssm_scan_plain(*map(torch.from_numpy, (dt, A, Bm, Cm, x)),
                              return_state=True, state_dtype=BF16)
    np.testing.assert_array_equal(h.numpy(), want[:, -1])
    c16 = np.asarray(jnp.asarray(Cm).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    np.testing.assert_allclose(y.numpy(), np.einsum("bscn,bsn->bsc", want,
                                                    c16), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 100, 8, 4, 8), (1, 300, 6, 4, 128),
                                   (1, 1500, 4, 4, 1024)])
def test_ssm_scan_chunked_bf16_states_equal_jax_bit_for_bit(shape):
    """The JAX rule: the chunk is shrunk to the largest divisor of S (5,
    100 and 750 here)."""
    b, s, d, n, chunk = shape
    dt, A, Bm, Cm, x = _inputs(b, s, d, n, s)
    a, bb = _ab(dt, A, Bm, x)
    hs, _ = jax.jit(JS._assoc_scan_chunked, static_argnums=3)(
        a, bb, jnp.zeros((b, d, n), jnp.bfloat16), chunk)
    want = np.asarray(hs.astype(jnp.float32))
    got = _states(lambda *t: ops.ssm_scan_chunked(*t, chunk=chunk,
                                                  state_dtype=BF16),
                  dt, A, Bm, Cm, x)
    np.testing.assert_array_equal(got.numpy(), want)
    y = ops.ssm_scan_chunked(*map(torch.from_numpy, (dt, A, Bm, Cm, x)),
                             chunk=chunk, state_dtype=BF16)
    jy = jnp.einsum("bscn,bsn->bsc", hs, jnp.asarray(Cm).astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)


def test_ssm_scan_chunked_takes_jax_chunks_only_at_bf16(monkeypatch):
    """At f32 the chunks stay SCAN_CHUNK long with a short last one (the
    numbers of the f32 path do not move); at bf16 they are S's largest
    divisor no longer than ``chunk``."""
    lengths = []
    chunk_fn = ops._scan_chunk
    monkeypatch.setattr(ops, "_scan_chunk", lambda h, dt, *a: lengths.append(
        dt.shape[1]) or chunk_fn(h, dt, *a))
    t = list(map(torch.from_numpy, _inputs(1, 300, 3, 2, 1)))
    ops.ssm_scan_chunked(*t)
    assert lengths == [128, 128, 44]
    lengths.clear()
    ops.ssm_scan_chunked(*t, state_dtype=BF16)
    assert lengths == [100, 100, 100]
    assert [ops.jax_chunk(s, c) for s, c in ((2048, 1024), (2039, 1024),
                                             (7, 8), (1, 1024))] == \
        [1024, 1, 7, 1]


def test_ssm_scan_function_bf16_gradients_match_jax():
    b, s, d, n, chunk = 1, 96, 6, 8, 32
    dt, A, Bm, Cm, x = _inputs(b, s, d, n, 2)
    g = np.random.default_rng(3).standard_normal((b, s, d)).astype(np.float32)

    def loss(dt, A, Bm, Cm, x):
        a, bb = _jax_ab(dt, A, Bm, x)
        hs, _ = JS._assoc_scan_chunked(a, bb, jnp.zeros((b, d, n),
                                                        jnp.bfloat16), chunk)
        y = jnp.einsum("bscn,bsn->bsc", hs, Cm.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * g)
    want = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(dt, A, Bm, Cm, x)
    ins = [torch.from_numpy(v).requires_grad_() for v in (dt, A, Bm, Cm, x)]
    y = ops.SSMScan.apply(*ins, BF16, chunk)
    got = torch.autograd.grad(y, ins, torch.from_numpy(g))
    for name, gp, gj in zip(("dt", "A", "Bm", "Cm", "x"), got, want):
        gj = np.asarray(gj)
        err = np.abs(gp.numpy() - gj).max() / np.abs(gj).max()
        assert err <= GRAD_TOL, (name, err)
    # and they are the bf16 scan's, not the f32 one's
    f32 = torch.autograd.grad(ops.SSMScan.apply(*ins), ins,
                              torch.from_numpy(g))
    assert not all(torch.equal(a, b) for a, b in zip(got, f32))


def test_ssm_scan_refuses_a_state_dtype_other_than_f32_and_bf16():
    t = list(map(torch.from_numpy, _inputs(1, 4, 2, 2, 4)))
    for fn in (ops.ssm_scan, ops.ssm_scan_plain, ops.ssm_scan_chunked):
        with pytest.raises(ValueError, match="ROADMAP queue 2 A3"):
            fn(*t, state_dtype=torch.float16)
