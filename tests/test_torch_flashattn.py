"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas kernel in interpret mode and its oracle, on the JAX test's
cases (tests/test_kernels_flashattn.py) with numpy-seeded inputs, and the
wrapper's argument checks.

Tolerance: 2e-6 for f32 (the sums are taken in another order), 2e-2 for
bf16 (one bf16 ulp of the output plus summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flashattn import flash_attention as jflash
from repro_torch.kernels import _build, flashattn

CASES = [
    # (B, H, Sq, Sk, D, bq, bk): the reference kernel's tiles
    (1, 2, 64, 64, 32, 32, 32),
    (2, 3, 100, 100, 32, 32, 32),
    (1, 1, 128, 256, 64, 64, 64),
    (1, 2, 33, 65, 16, 16, 16),
    # D 128 at lengths that are not multiples of the 128-row tiles
    (1, 2, 200, 200, 128, 128, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(case, seed):
    B, H, Sq, Sk, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D))]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not \
        isinstance(a, torch.Tensor) else a.to(torch.float32).numpy()


# the reference's test leaves out non-causal cross lengths (its oracle
# aligns positions)
MASKED_CASES = [(c, causal, window) for c in CASES
                for causal, window in ((True, None), (True, 24), (False, None))
                if causal or c[2] == c[3]]
# whisper-small's non-causal launches at D 64, scaled down: the
# cross-attention's few queries on more keys (its 32 on 1500 frames), and
# the encoder's self-attention at a length no tile divides (its 1500)
MASKED_CASES += [((1, 3, 32, 300, 64, 32, 128), False, None),
                 ((1, 2, 150, 150, 64, 64, 64), False, None)]
# recurrentgemma-2b's local attention at D 256, causal: a window narrower
# than the length, and a length no tile divides
MASKED_CASES += [((1, 2, 150, 150, 256, 64, 64), True, 64),
                 ((2, 1, 70, 70, 256, 32, 32), True, None)]


@pytest.mark.parametrize(
    "case,causal,window", MASKED_CASES,
    ids=lambda x: "x".join(map(str, x[:5])) if isinstance(x, tuple) else
    str(x))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_flash_matches_pallas_kernel_and_oracle(case, dtype, causal,
                                                      window):
    B, H, Sq, Sk, D, bq, bk = case
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(case, seed=B * 7 + Sq)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flashattn.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, H, Sq, D)
    kernel = jflash(jq, jk, jv, causal=causal, window=window, bq=bq, bk=bk,
                    interpret=True)
    oracle = jref.flash_attention(jq, jk, jv, causal=causal, window=window)
    for want in (kernel, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_gqa_layout_equals_repeated_heads():
    """The model's layout (B, S, H, D) with grouped KV heads computes the
    public function on transposed, repeated copies."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 40, 6, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 32)).astype(np.float32))
    got = flashattn.gqa_flash_attention(q, k, v, causal=True, window=7)
    want = flashattn.flash_attention(
        q.transpose(1, 2), k.repeat_interleave(3, 2).transpose(1, 2),
        v.repeat_interleave(3, 2).transpose(1, 2), causal=True, window=7)
    assert torch.equal(got, want.transpose(1, 2))


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v: (q[0], k, v), "rank 4"),
    (lambda q, k, v: (q.to(torch.float16), k, v), "dtype"),
    (lambda q, k, v: (q.to(torch.int32), k, v), "dtype"),
    (lambda q, k, v: (q, k.to(torch.bfloat16), v), "q is torch.float32"),
    (lambda q, k, v: (q, k, v[:, :, :5]), "differ"),
    (lambda q, k, v: (q[..., :16], k, v), "batch or head dim"),
    (lambda q, k, v: (q[:1], k, v), "batch or head dim"),
    (lambda q, k, v: (q, k[:, :1], v[:, :1]), "repeat the KV heads"),
])
def test_wrapper_rejects_bad_arguments(bad, match):
    q, k, v = (torch.zeros(2, 4, 8, 32) for _ in range(3))
    with pytest.raises(ValueError, match=match):
        flashattn.flash_attention(*bad(q, k, v))


def test_wrapper_rejects_rows_that_see_no_key():
    q, k, v = (torch.zeros(1, 1, 8, 32) for _ in range(3))
    with pytest.raises(ValueError, match="window"):
        flashattn.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="see no key"):
        flashattn.flash_attention(q, k[:, :, :2], v[:, :, :2], window=6)
    with pytest.raises(ValueError, match="multiple"):
        flashattn.gqa_flash_attention(torch.zeros(1, 8, 3, 32),
                                      torch.zeros(1, 8, 2, 32),
                                      torch.zeros(1, 8, 2, 32))


def test_plain_path_launches_nothing():
    flashattn.reset_launches()
    q = torch.zeros(1, 2, 8, 32)
    flashattn.flash_attention(q, q, q)
    assert flashattn.LAUNCHES == {"flash_attention": 0}
    assert flashattn.VARIANT_LAUNCHES == dict.fromkeys(flashattn.VARIANTS, 0)


@pytest.mark.parametrize("name", sorted(_build.SOURCE_FLAGS))
def test_library_path_depends_on_its_own_flags_only(name, monkeypatch):
    """Each source's library name hashes that source's flags: changing one
    source's flags renames its library and leaves the other's (no nvcc is
    called)."""
    before = {n: _build.library_path(n) for n in _build.SOURCE_FLAGS}
    monkeypatch.setitem(_build.SOURCE_FLAGS, name,
                        _build.SOURCE_FLAGS[name] + ("-lineinfo",))
    after = {n: _build.library_path(n) for n in _build.SOURCE_FLAGS}
    for n in _build.SOURCE_FLAGS:
        assert (after[n] != before[n]) == (n == name), n
    assert "-fmad=false" in _build.flags("quant8")
    assert "-fmad=false" not in _build.flags("flashattn")
