"""The rounding points of the bf16 tensor-core attention kernels, on the CPU.

The bf16 forward and split backward cannot run here. ``torch_attention_bf16_model``
writes their arithmetic as plain torch: bf16 operands, f32 products and sums,
P rounded to bf16 before P.V and P^T.dO, dS rounded to bf16 before dS.K and
dS^T.Q, f32 statistics, delta = rowsum(P * dP) in f32 (the stats pass). This
file holds that model

(a) against the JAX package's Pallas kernels in interpret mode on the same
    bf16 inputs: the forward K1 (``flash_attention``), the streaming
    backward K5 (``flash_attention_bwd_streaming``) and the fused backward
    K3 (``flash_attention_bwd_fused``, against the model's dQ summed over kv
    blocks in order, as the Hopper K3 adds it), which round at the same
    points (``p.astype(v.dtype)``, ``t.astype(k.dtype)``, ``p.astype(v.dtype)``,
    ``t.astype(q.dtype)``), on independent and on correlated inputs (dO = Q,
    V = K, as self-attention feeds the kernels). Tolerance 1e-2 of
    max(1, max|Pallas|) per output: both sides round their outputs to bf16
    (spacing 2^-8 to 2^-7 of the magnitude), and the Pallas kernels also
    round q * scale * log2(e) to bf16 before Q K^T, a rounding the Hopper
    kernels do not make (they scale the f32 scores), which moves each score
    by about 2^-9 of its size. Where keys share a large component, the dS
    rounding shows: K5's dQ departs from the f32 plain version about as far
    as the model's, and the model without that rounding stays 10x closer;
(b) against the port's plain versions (``flash_attention_plain``,
    ``flash_attention_bwd_plain``: f32 from the bf16 inputs, one rounding of
    each output), which ``chip_smoke.py`` holds the kernels to on the card, at
    head dims 40, 80 and 160 and one longer kv length, within its bf16
    tolerance of 2e-2 of max|plain| (the output's own magnitude): the model's
    extra roundings of P and dS must stay inside it before a chip run can;
    and a planted fault, one kv (or q) tile of 64 skipped at 16384 tokens,
    must fall outside it.

And it records why the kernels' delta is a stats pass: delta =
rowsum(dO * O) from the bf16 output, which the kernels read before it, moves
dQ by several times the chip tolerance at correlated inputs whose keys share
a large component, where the f32 sum of P * dP that K3, K4 and K5 take (and
the kernels now take) stays inside it.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_attention_bf16_model import (  # noqa: E402
    exact_delta,
    model_backward,
    model_backward_fused,
    model_forward,
    own_scale_err,
)

from stable_diffusion_pytorch_tpu.ops import flash_attention as jax_fa  # noqa: E402
from stable_diffusion_pytorch_tpu.ops import flash_attention_bwd as jax_fa_bwd  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (  # noqa: E402
    backward_route,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

torch.set_num_threads(2)
PALLAS_TOL = 1e-2
PLAIN_TOL = 2e-2  # chip_smoke.py TOLERANCE["flash_attention*"]["bfloat16"], of max|plain|


def _inputs(seed, b, n, m, h, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).bfloat16()
            for s in (n, m, m, n)]


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _torch(a):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("m", [77, 200])
def test_model_matches_pallas_k1_forward_in_bf16(m):
    b, n, h, d = 1, 96, 2, 40
    q, k, v, _ = _inputs(0, b, n, m, h, d)
    scale = d ** -0.5
    ref = _torch(jax_fa.flash_attention(_jnp(q), _jnp(k), _jnp(v), scale, interpret=True))
    out, _ = model_forward(q, k, v, scale)
    assert _rel(out, ref) <= PALLAS_TOL


def test_model_matches_pallas_k5_backward_in_bf16():
    b, n, m, h, d = 1, 96, 200, 2, 40
    q, k, v, do = _inputs(1, b, n, m, h, d)
    scale = d ** -0.5
    o, lse2 = model_forward(q, k, v, scale)
    refs = jax_fa_bwd.flash_attention_bwd_streaming(*(_jnp(t) for t in (q, k, v, do)), scale, interpret=True,
                                                    block_n=64, block_m=128)
    for got, ref in zip(model_backward(q, k, v, o, do, lse2, scale), refs):
        assert got.dtype == torch.bfloat16
        assert _rel(got, _torch(ref)) <= PALLAS_TOL


def test_k3_model_matches_pallas_k3_in_bf16():
    """The fused backward's rounding points (P and dS rounded to bf16, dQ the
    sum of kv blocks' shares in block order) against the Pallas K3 on bf16
    inputs at ragged lengths (q 70, kv 300: three kv blocks of 128, the last
    one short)."""
    b, n, m, h, d = 1, 70, 300, 2, 40
    q, k, v, do = _inputs(5, b, n, m, h, d)
    scale = d ** -0.5
    o, lse2 = model_forward(q, k, v, scale)
    refs = jax_fa_bwd.flash_attention_bwd_fused(*(_jnp(t) for t in (q, k, v, do)), scale, interpret=True)
    for got, ref in zip(model_backward_fused(q, k, v, o, do, lse2, scale), refs):
        assert got.dtype == torch.bfloat16
        assert _rel(got, _torch(ref)) <= PALLAS_TOL


def _k5(q, k, v, do, scale):
    refs = jax_fa_bwd.flash_attention_bwd_streaming(*(_jnp(t) for t in (q, k, v, do)), scale, interpret=True,
                                                    block_n=64, block_m=128)
    return [_torch(r) for r in refs]


def _shared_key_inputs(seed, n, m, h, d, offset):
    """Correlated inputs (dO = Q, V = K) whose keys share one component of
    size ``offset``. dQ = scale * sum_m dS_m k_m and sum_m dS_m = 0 cancel that
    component exactly, so an error common to a row's dS shows at its size."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((1, n, h, d)).astype(np.float32)).bfloat16()
    shared = offset * rng.standard_normal((1, 1, h, d))
    k = torch.from_numpy((shared + rng.standard_normal((1, m, h, d))).astype(np.float32)).bfloat16()
    return q, k, k, q


def test_model_matches_pallas_k5_at_correlated_inputs():
    """dO = Q and V = K at head dim 100 and ragged lengths: dP = Q K^T, the
    scores themselves, so dS = P (dP - delta) cancels hard."""
    q, k, _, _ = _inputs(3, 1, 70, 130, 2, 100)
    scale = 100 ** -0.5
    o, lse2 = model_forward(q, k, k, scale)
    for got, ref in zip(model_backward(q, k, k, o, q, lse2, scale), _k5(q, k, k, q, scale)):
        assert _rel(got, ref) <= PALLAS_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_k5_rounds_ds_where_the_model_does(seed):
    """Keys sharing a component of size 10 (dO = Q, V = K, head dim 40): the
    bf16 rounding of dS no longer cancels in dQ. With K5's delta (an f32 sum
    of P dP) the model's dQ departs from the f32 plain version about as far as
    K5's does (between half and twice); the model without the dS rounding
    fails that comparison, staying within a third of K5's departure."""
    q, k, v, do = _shared_key_inputs(seed, 96, 200, 2, 40, 10.0)
    scale = 40 ** -0.5
    o, lse2 = model_forward(q, k, v, scale)
    plain = flash_attention_bwd_plain(q, k, v, do, scale)[0]
    k5 = own_scale_err(_k5(q, k, v, do, scale)[0], plain)
    delta = exact_delta(q, k, v, do, lse2, scale)
    rounded = own_scale_err(model_backward(q, k, v, o, do, lse2, scale, delta=delta)[0], plain)
    unrounded = own_scale_err(model_backward(q, k, v, o, do, lse2, scale, delta=delta, round_ds=False)[0], plain)
    assert k5 / 2 <= rounded <= 2 * k5, (k5, rounded)
    assert unrounded <= k5 / 3, (k5, unrounded)


# (n, m, d) of the shared-key inputs: the UNet's head dims 40, 80 and 160 at
# the kv lengths of its levels (cut to stay small), and 100 (no multiple of 8)
SHARED_KEY_CASES = [(128, 1024, 40), (128, 1024, 80), (96, 200, 100), (64, 2048, 160)]


def delta_readings(n, m, d):
    """dQ's departure from the plain version, of its own scale, at keys sharing
    a component of size 3 (dO = Q, V = K): (the model with the kernels'
    delta, the stats pass's f32 rowsum(P * dP); with rowsum(dO * O) from the
    bf16 O, the delta the kernels read before the stats pass)."""
    q, k, v, do = _shared_key_inputs(0, n, m, 2, d, 3.0)
    scale = d ** -0.5
    o, lse2 = model_forward(q, k, v, scale)
    plain = flash_attention_bwd_plain(q, k, v, do, scale)[0]
    kernels = own_scale_err(model_backward(q, k, v, o, do, lse2, scale)[0], plain)
    output = own_scale_err(model_backward(q, k, v, o, do, lse2, scale, delta="output")[0], plain)
    return kernels, output


@pytest.mark.parametrize("n,m,d", SHARED_KEY_CASES)
def test_delta_from_the_bf16_output_departs_at_shared_keys(n, m, d):
    """The bf16 backward's delta is the stats pass's f32 sum of P dP, as in
    the TPU kernels: at keys sharing a component of 3 its dQ stays within the
    chip tolerance, while rowsum(dO * O) from the bf16 output, which the
    kernels read before that pass, departs by more than it: O's rounding
    enters every dS of a row alike and is multiplied by the shared component."""
    kernels, output = delta_readings(n, m, d)
    assert kernels <= PLAIN_TOL < output, (kernels, output)
    if d == 100:  # and K5 itself, the TPU kernel whose stats pass this is
        q, k, v, do = _shared_key_inputs(0, n, m, 2, d, 3.0)
        plain = flash_attention_bwd_plain(q, k, v, do, d ** -0.5)[0]
        assert own_scale_err(_k5(q, k, v, do, d ** -0.5)[0], plain) <= PLAIN_TOL


@pytest.mark.parametrize("n,m,d", [(96, 77, 40), (100, 130, 80), (70, 200, 160), (64, 4096, 40)])
def test_model_stays_within_the_chip_tolerance_of_the_plain_versions(n, m, d):
    q, k, v, do = _inputs(2, 1, n, m, 2, d)
    scale = d ** -0.5
    o, lse2 = model_forward(q, k, v, scale)
    assert own_scale_err(o, flash_attention_plain(q, k, v, scale)) <= PLAIN_TOL
    for got, ref in zip(model_backward(q, k, v, o, do, lse2, scale),
                        flash_attention_bwd_plain(q, k, v, do, scale)):
        assert got.shape == ref.shape and got.dtype == ref.dtype == torch.bfloat16
        assert own_scale_err(got, ref) <= PLAIN_TOL


def _skip_last_tile(t):
    """``t`` [B, L, H, D] without its last 64 rows of L: one tile left out."""
    return t[:, :-64]


def fault_readings(case):
    """(the model's error, the error of the model with one tile of 64 skipped),
    each of the output's own scale, against the plain version at 16384 tokens,
    on a slice of the other side's rows (each row's outputs are independent):
    ``fwd40``/``fwd512`` K1 skipping the last kv tile (the K2 shapes' head dim
    and the VAE's), ``dq`` the dQ kernel skipping the last kv tile, ``dkv``
    the dK/dV kernel skipping the last q tile (the worse of dK and dV, as
    ``chip_smoke.py`` takes the worst output)."""
    d = {"fwd40": 40, "fwd512": 512, "dq": 40, "dkv": 40}[case]
    n, m = (16384, 128) if case == "dkv" else (64, 16384)
    q, k, v, do = _inputs(4, 1, n, m, 1, d)
    scale = d ** -0.5
    o, lse2 = model_forward(q, k, v, scale)
    if case.startswith("fwd"):
        plain = flash_attention_plain(q, k, v, scale)
        faulty = model_forward(q, _skip_last_tile(k), _skip_last_tile(v), scale)[0]
        return own_scale_err(o, plain), own_scale_err(faulty, plain)
    plain = flash_attention_bwd_plain(q, k, v, do, scale)
    sound = model_backward(q, k, v, o, do, lse2, scale)
    if case == "dq":
        faulty = model_backward(q, _skip_last_tile(k), _skip_last_tile(v), o, do, lse2, scale)[:1]
        return own_scale_err(sound[0], plain[0]), own_scale_err(faulty[0], plain[0])
    faulty = model_backward(_skip_last_tile(q), k, v, _skip_last_tile(o), _skip_last_tile(do), lse2[..., :-64],
                            scale)[1:]
    return (max(own_scale_err(g, r) for g, r in zip(sound[1:], plain[1:])),
            max(own_scale_err(g, r) for g, r in zip(faulty, plain[1:])))


@pytest.mark.parametrize("case", ["fwd40", "fwd512", "dq", "dkv"])
def test_chip_tolerance_catches_a_skipped_tile(case):
    """The chip's bf16 limit, 2e-2 of max|plain|, holds the sound model and
    refuses one that skips a tile of 64 at 16384 tokens, where outputs are
    ~0.02-0.05 and a floor of 1 on the scale would let the fault pass."""
    sound, fault = fault_readings(case)
    assert sound <= PLAIN_TOL < fault, (sound, fault)




def test_bf16_backward_runs_the_split_set_at_every_length():
    """bfloat16 takes the split set at every kv length (measured faster than
    the tensor-core K3 at K3's shapes, PERF.md); float32 keeps the JAX
    crossover at 9216 padded kv tokens."""
    for kv_len in (77, 4096, 9216, 16384):
        assert backward_route(kv_len, {}, torch.bfloat16) == "split"
    assert backward_route(4096, {}, torch.float32) == "fused"
    assert backward_route(9217, {}, torch.float32) == "split"
