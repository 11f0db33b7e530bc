"""The flash plain versions in bf16 against the reference's Pallas flash
kernels in interpret mode, run in bf16, on the CPU.

In bf16 the place where a kernel rounds moves its result: the reference's
two backward kernels put the exp2-space factor ``c = scale*log2e`` on
different operands (the dq kernel on q, the dk/dv kernel on its resident
k tile), and the port's plain backward follows each form's points
(``_flash_bwd_plain(..., form=...)``).  Each output is scored with the
port's own bf16 limit, ``chip_smoke.flash_tolerance`` with the plain
version's own rounding (``chip_smoke.flash_noise``) for its form: 1 is at
the limit.  The reference runs with out and lse from the port's plain
forward, so the backward comparisons see one forward.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as ref_pk

from chip_smoke import flash_excess, flash_noise, flash_tolerance
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

# share of flash_tolerance each backward output may use against the
# reference: the plain version and the reference round the same operands
# at the same points, so what is left is the fp32 summation order under
# bf16 rounding (with c on the other operand the fused dq read 1.08 of
# the limit on the witness, dq, dk and dv 0.53-1.17 over these cases)
MAX_EXCESS = 0.5
# the forward is held to the limit itself: its one rounding after the
# sums can land one ulp apart, which reads 0.51 at |out| = 0.5 in
# causal_rope (the ulp term of the limit is one ulp of the value)
FWD_MAX_EXCESS = 1.0

# (causal, rope, Sq, Sk, D, block): the witness (where the fused dq read
# 1.1 of the limit while the plain backward put c on q in both forms),
# then the causal mask with rope, a longer key axis, and rows that see
# nothing (Sq > Sk); then the head dims the CUDA-core kernels take in
# bf16 (32, llama_tiny_config's, and 96) over several k blocks
CASES = {
    "witness": (False, False, 256, 256, 128, 64),
    "causal_rope": (True, True, 64, 64, 32, 32),
    "rect_causal": (True, False, 32, 64, 32, 32),
    "dead_rows_causal": (True, False, 64, 32, 32, 32),
    "d32_full_rope": (False, True, 128, 128, 32, 64),
    "d96_causal_rope": (True, True, 128, 128, 96, 64),
}
FORMS = {"flash_bwd_fused": ref_pk._flash_attention_bwd_fused,
         "flash_bwd_two_kernel": ref_pk._flash_attention_bwd}


def _inputs(case, seed=1):
    """bf16 torch tensors [B, S, H, D] (B 1, H 2) made with numpy, and
    the rope tables or None."""
    causal, rope, Sq, Sk, D, _ = CASES[case]
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(1, Sq, 2, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, Sk, 2, D).astype(np.float32) for _ in range(2))
    tables = None
    if rope:
        tables = tuple(torch.from_numpy(np.array(t))
                       for t in ref_pk.rope_tables(Sq, D))
    return causal, tables, [torch.from_numpy(x).to(torch.bfloat16)
                            for x in (q, k, v, g)]


def _to_ref(t):
    """bf16 [B, S, H, D] torch -> the reference's [B, H, S, D] bf16."""
    return jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3),
                       dtype=jnp.bfloat16)


def _from_ref(x):
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))
                            .transpose(0, 2, 1, 3).copy())


@pytest.fixture
def interpret():
    old = ref_pk._INTERPRET[0]
    ref_pk._INTERPRET[0] = True
    yield
    ref_pk._INTERPRET[0] = old


def _excess(kernel, got_ref, want, args, causal, tables):
    """flash_excess of the reference's outputs against the plain
    version's, per output."""
    noise = flash_noise(kernel, *args, causal, tables)
    return [flash_excess(a, b, flash_tolerance(b, "bfloat16", f))
            for a, b, f in zip(got_ref, want, noise)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_forward_matches_pallas_interpret(case, interpret):
    causal, tables, (q, k, v, _) = _inputs(case)
    block = CASES[case][-1]
    out, lse = fa._flash_fwd_plain(q, k, v, causal, tables)
    rope_j = None if tables is None else tuple(jnp.asarray(t.numpy())
                                               for t in tables)
    ref_out, ref_lse = ref_pk._flash_attention_value(
        _to_ref(q), _to_ref(k), _to_ref(v), causal, block_q=block,
        block_k=block, with_lse=True, rope=rope_j)
    excess = _excess("flash_fwd", (_from_ref(ref_out),), (out,),
                     (q, k, v, None, None, None), causal, tables)
    assert max(excess) <= FWD_MAX_EXCESS, excess
    ref_lse = torch.from_numpy(np.asarray(ref_lse)).reshape(lse.shape)
    dead = torch.isneginf(lse)
    assert torch.equal(torch.isneginf(ref_lse), dead)
    assert bool(dead.any()) == (case == "dead_rows_causal")
    torch.testing.assert_close(ref_lse[~dead], lse[~dead], rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("kernel", sorted(FORMS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_backward_matches_pallas_interpret(case, kernel,
                                                      interpret):
    """dq, dk, dv of the wrapper's CPU branch (the plain version of its
    form) against the reference's kernels of that form, in bf16."""
    causal, tables, (q, k, v, g) = _inputs(case)
    block = CASES[case][-1]
    out, lse = fa._flash_fwd_plain(q, k, v, causal, tables)
    got = getattr(fa, kernel)(q, k, v, out, lse, g, causal, tables)
    rope_j = None if tables is None else tuple(jnp.asarray(t.numpy())
                                               for t in tables)
    ref = FORMS[kernel](_to_ref(q), _to_ref(k), _to_ref(v), _to_ref(out),
                        jnp.asarray(lse.reshape(-1, lse.shape[-1]).numpy()),
                        _to_ref(g), causal, block_q=block, block_k=block,
                        rope=rope_j)
    excess = _excess(kernel, [_from_ref(x) for x in ref], got,
                     (q, k, v, out, lse, g), causal, tables)
    assert max(excess) <= MAX_EXCESS, dict(zip(("dq", "dk", "dv"), excess))


def test_bf16_forms_round_at_their_own_points():
    """The two forms agree on dk and dv bitwise and differ on dq only by
    rounding: c sits on k for the fused dq, on q for the two-kernel dq."""
    causal, tables, (q, k, v, g) = _inputs("witness")
    out, lse = fa._flash_fwd_plain(q, k, v, causal, tables)
    fused = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                                form="fused")
    two = fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                              form="two_kernel")
    assert torch.equal(fused[1], two[1]) and torch.equal(fused[2], two[2])
    assert not torch.equal(fused[0], two[0])
    with pytest.raises(ValueError, match="form"):
        fa._flash_bwd_plain(q, k, v, out, lse, g, causal, tables,
                            form="both")
