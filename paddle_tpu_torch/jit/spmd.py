"""The serving half of ``paddle_tpu/jit/spmd.py``: meshes, the per-weight
family partition specs, the validation of a sharded engine, the
per-rank :class:`TPContext` with its collective accounting, the traced
helpers of the sharded steps (vocab-parallel embedding, the exact and the
int8 logits all-gather), and building a rank's shard of a model.

The tables are the reference's, key for key (its module notes give the
Megatron layout: q/k/v, gate/up and the LM head column-sharded over
``tp``, o_proj, down and the embedding row-sharded, norms and the MoE
router replicated, the MoE expert banks' E dim over ``ep``, the KV pools
over kv heads).  Specs are written in the reference's layout, where a
``Linear`` weight is ``[in, out]``; the port stores ``[out, in]``, so
:func:`port_spec` reverses a 2-D Linear weight's spec before a tensor is
cut.

Where the reference runs one SPMD program over a device mesh, the port
runs one process a rank (``distributed/process_mesh.py``): each rank
holds only its shard — built with :func:`shard_model` parameter by
parameter, from the seed or from a state, never the whole model on the
card — and runs the steps over it with the collectives of
``distributed/collective.py`` at the reference's points (one sum after
the embedding, after each o_proj and each down projection, one logits
all-gather; the MoE dispatch's two all_to_alls and one all_gather).

The other axes: ``fsdp`` (:func:`mesh_2d`) shards each weight family's
non-tp dim for storage — a rank stores ``1/(fsdp·tp)`` of such a weight
and :class:`FsdpParams` gathers its tp compute shard back, one layer at a
time into a reused scratch, at every dispatch (the reference's
``_wrap_sharded`` prologue); ``cp`` (:func:`cp_mesh`) stripes every KV
pool's slot dim (``block_size / cp`` slots of every page a rank), and
the attention merges the ranks' partial softmax rows
(``ops/online_softmax.cross_chip_merge``); a ``dp`` replica axis is named
by no spec, so weights and pools replicate across it.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..distributed.process_mesh import AxisComm, ProcessMesh, as_mesh

__all__ = ["PartitionSpec", "P", "ShardingConfig", "SpecLayout",
           "TPContext", "FsdpParams", "resolve_mesh_axis",
           "llama_param_specs", "mixtral_param_specs", "validate_tp_serving",
           "validate_cp_serving", "validate_ep_serving", "tp_mesh",
           "ep_mesh", "cp_mesh", "mesh_2d", "tp_serving_context", "tp_embed",
           "tp_gather_logits", "tp_gather_logits_q8", "prune_spec_axes",
           "spec_axes", "fsdp_gather", "port_spec", "shard_tensor",
           "shard_model", "full_shapes", "reference_shapes",
           "gather_spec_axes", "scatter_spec_axes"]


class PartitionSpec(tuple):
    """One entry per array dim: ``None`` (whole), an axis name, or a tuple
    of axis names (major to minor); trailing dims are whole.  Equal to the
    reference's ``jax.sharding.PartitionSpec`` with the same entries as a
    tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class ShardingConfig:
    """The reference's ``ShardingConfig``; serving reads ``degree`` and
    ``axis`` (``stage``, ``bucket_mb`` and ``loss_reduction`` are the
    training step's, validated the same way)."""

    def __init__(self, stage: int = 1, degree: int = -1, axis: str = "dp",
                 bucket_mb: float = 25.0, loss_reduction: str = "mean"):
        if int(stage) not in (1, 2):
            raise ValueError(
                f"ShardingConfig stage must be 1 (os) or 2 (os_g), got "
                f"{stage!r}; stage-3 (params themselves sharded) is not a "
                f"stage knob here — pass a mesh with an 'fsdp' axis "
                f"(spmd.mesh_2d) and the fsdp×tp TrainStep stores the "
                f"params ZeRO-3-sharded as its natural layout")
        if loss_reduction not in ("mean", "sum"):
            raise ValueError(
                f"loss_reduction must be 'mean' or 'sum', got "
                f"{loss_reduction!r}")
        self.stage = int(stage)
        self.degree = int(degree)
        self.axis = axis
        self.bucket_mb = float(bucket_mb)
        self.loss_reduction = loss_reduction

    def __repr__(self):
        return (f"ShardingConfig(stage={self.stage}, degree={self.degree}, "
                f"axis={self.axis!r}, bucket_mb={self.bucket_mb}, "
                f"loss_reduction={self.loss_reduction!r})")


def resolve_mesh_axis(mesh, axis: str, degree: int = -1,
                      candidates: Sequence[str] = ("dp", "sharding", "data"),
                      ) -> Tuple[ProcessMesh, str, int]:
    """The mesh and the axis to shard over (reference:
    ``resolve_mesh_axis``): ``axis`` when the mesh has it, else the first
    of ``candidates`` present with size > 1; ``degree`` must equal its
    size or be -1."""
    if mesh is None:
        raise ValueError("ShardingConfig requires a mesh")
    pm = as_mesh(mesh)
    sizes = pm.axis_sizes()
    if axis not in sizes:
        axis = next((a for a in candidates
                     if a in sizes and sizes[a] > 1), None)
        if axis is None:
            raise ValueError(
                f"no shardable axis on mesh {tuple(pm.dim_names)} "
                f"(wanted one of {tuple(candidates)})")
    deg = sizes[axis]
    if degree not in (-1, deg):
        raise ValueError(
            f"sharding degree {degree} must equal the '{axis}' axis "
            f"size {deg} (or -1 to infer)")
    return pm, axis, deg


def tp_mesh(tp: int, axis: str = "tp", backend: Optional[str] = None):
    """A 1-D ``tp``-rank mesh; ``backend`` the data groups' (``"gloo"``
    or ``"nccl"``), needed when an engine binds it."""
    return ProcessMesh(shape=[int(tp)], dim_names=[axis], backend=backend)


def ep_mesh(ep: int, tp: int = 1, ep_axis: str = "ep", tp_axis: str = "tp",
            backend: Optional[str] = None):
    """The ``(ep, tp)`` serving mesh (``tp=1``: pure expert parallelism):
    rank ``r`` sits at ``(r // tp, r % tp)``."""
    if tp > 1:
        return ProcessMesh(shape=[int(ep), int(tp)],
                           dim_names=[ep_axis, tp_axis], backend=backend)
    return ProcessMesh(shape=[int(ep)], dim_names=[ep_axis],
                       backend=backend)


def _check_ranks(what: str, *degrees: int) -> None:
    """A mesh of ``degrees``: each >= 1, and no more ranks than the joined
    world holds (the reference's check against the visible devices;
    without a world nothing is checked until the engine binds)."""
    if min(int(d) for d in degrees) < 1:
        raise ValueError("%s: every degree must be >= 1" % what)
    need = math.prod(int(d) for d in degrees)
    import torch.distributed as dist
    if dist.is_initialized() and need > dist.get_world_size():
        raise ValueError(
            "%s needs %d ranks but the world has %d; start that many ranks "
            "(paddle_tpu_torch.distributed.launch.run_world)"
            % (what, need, dist.get_world_size()))


def mesh_2d(fsdp: int, tp: int, replica: int = 1, fsdp_axis: str = "fsdp",
            tp_axis: str = "tp", replica_axis: str = "dp",
            backend: Optional[str] = None):
    """The ``(fsdp, tp)`` mesh (reference: ``mesh_2d``); ``replica > 1``
    puts a data-parallel axis first (``["dp", "fsdp", "tp"]``: weights and
    pools replicate across it, no spec names it)."""
    _check_ranks("mesh_2d(replica=%s, fsdp=%s, tp=%s)" % (replica, fsdp, tp),
                 replica, fsdp, tp)
    if replica > 1:
        return ProcessMesh(shape=[int(replica), int(fsdp), int(tp)],
                           dim_names=[replica_axis, fsdp_axis, tp_axis],
                           backend=backend)
    return ProcessMesh(shape=[int(fsdp), int(tp)],
                       dim_names=[fsdp_axis, tp_axis], backend=backend)


def cp_mesh(cp: int, tp: int = 1, cp_axis: str = "cp", tp_axis: str = "tp",
            backend: Optional[str] = None):
    """The ``(cp, tp)`` serving mesh (reference: ``cp_mesh``): ``cp``
    stripes every KV pool's slot dim, so a rank's pools are ``1/cp`` of a
    one-card engine's; ``tp=1`` is pure context parallelism (weights
    replicate: no spec names cp)."""
    _check_ranks("cp_mesh(cp=%s, tp=%s)" % (cp, tp), cp, tp)
    if tp > 1:
        return ProcessMesh(shape=[int(cp), int(tp)],
                           dim_names=[cp_axis, tp_axis], backend=backend)
    return ProcessMesh(shape=[int(cp)], dim_names=[cp_axis], backend=backend)


# ---------------------------------------------------------------------------
# canonical per-weight-family specs (the reference's tables)
# ---------------------------------------------------------------------------
class SpecLayout:
    """The reference's ``SpecLayout``: ``tp`` shards compute (Megatron),
    ``fsdp`` each family's non-tp dim for storage, ``cp`` only the KV
    pools' slot dim, ``ep`` only the MoE expert banks' E dim; any axis may
    be None."""

    def __init__(self, tp_axis: Optional[str] = "tp",
                 fsdp_axis: Optional[str] = None,
                 cp_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None):
        self.tp_axis = tp_axis
        self.fsdp_axis = fsdp_axis
        self.cp_axis = cp_axis
        self.ep_axis = ep_axis

    def embeddings(self) -> PartitionSpec:
        return P(self.tp_axis, self.fsdp_axis)

    def qkv_projection(self) -> PartitionSpec:
        return P(self.fsdp_axis, self.tp_axis)

    def qkv_bias(self) -> PartitionSpec:
        return P(self.tp_axis)

    def attn_output(self) -> PartitionSpec:
        return P(self.tp_axis, self.fsdp_axis)

    def ffn_up(self) -> PartitionSpec:
        return P(self.fsdp_axis, self.tp_axis)

    def ffn_down(self) -> PartitionSpec:
        return P(self.tp_axis, self.fsdp_axis)

    def lm_head(self) -> PartitionSpec:
        return P(self.fsdp_axis, self.tp_axis)

    def replicated(self) -> PartitionSpec:
        return P()

    def fsdp_default(self) -> PartitionSpec:
        return P(self.fsdp_axis) if self.fsdp_axis else P()

    def kv_pool(self) -> PartitionSpec:
        """[phys_pages, block_size, Hkv, D]: slots over cp, kv heads over
        tp."""
        return P(None, self.cp_axis, self.tp_axis, None)

    def kv_scale(self) -> PartitionSpec:
        return P(None, self.tp_axis)

    def expert_bank(self) -> PartitionSpec:
        return P(self.ep_axis, None, None)

    def expert_bank_scale(self) -> PartitionSpec:
        return P(self.ep_axis, None, None)

    def col_weight_scale(self) -> PartitionSpec:
        return P(self.tp_axis)

    def row_weight_scale(self) -> PartitionSpec:
        return P()


WEIGHT_SCALE_SUFFIX = "::scale"     # quantization.functional's suffix


def llama_param_specs(keys: Iterable[str],
                      layout: Optional[SpecLayout] = None,
                      shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                      mesh=None) -> Dict[str, PartitionSpec]:
    """Classify Llama state-dict keys (and PTQ ``::scale`` keys) into the
    family specs (reference: ``llama_param_specs``); with ``shapes`` and
    ``mesh`` each spec is pruned to what the dims divide."""
    layout = layout or SpecLayout()
    specs: Dict[str, PartitionSpec] = {}
    for k in keys:
        if k.endswith(WEIGHT_SCALE_SUFFIX):
            base = k[:-len(WEIGHT_SCALE_SUFFIX)]
            if any(p in base for p in ("q_proj", "k_proj", "v_proj",
                                       "gate_proj", "up_proj",
                                       "lm_head")):
                specs[k] = layout.col_weight_scale()
            elif "o_proj" in base or "down_proj" in base:
                specs[k] = layout.row_weight_scale()
            else:
                specs[k] = layout.replicated()
        elif "embed_tokens" in k:
            specs[k] = layout.embeddings()
        elif any(p in k for p in ("q_proj", "k_proj", "v_proj")):
            specs[k] = layout.qkv_bias() if k.endswith("bias") \
                else layout.qkv_projection()
        elif "o_proj" in k:
            specs[k] = layout.attn_output()
        elif "gate_proj" in k or "up_proj" in k:
            specs[k] = layout.ffn_up()
        elif "down_proj" in k:
            specs[k] = layout.ffn_down()
        elif "lm_head" in k:
            specs[k] = layout.lm_head()
        else:
            specs[k] = layout.fsdp_default()
    if shapes is not None and mesh is not None:
        specs = {k: prune_spec_axes(s, shapes[k], mesh)
                 if k in shapes else s for k, s in specs.items()}
    return specs


_EXPERT_BANK_FAMILIES = ("w_gate", "w_up", "w_down")


def mixtral_param_specs(keys: Iterable[str],
                        layout: Optional[SpecLayout] = None,
                        shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                        mesh=None) -> Dict[str, PartitionSpec]:
    """The MoE classifier (reference: ``mixtral_param_specs``): expert
    banks and their scales ``P(ep, None, None)``, the router replicated,
    everything else :func:`llama_param_specs`."""
    layout = layout or SpecLayout()
    specs: Dict[str, PartitionSpec] = {}
    rest = []
    for k in keys:
        base = k[:-len(WEIGHT_SCALE_SUFFIX)] \
            if k.endswith(WEIGHT_SCALE_SUFFIX) else k
        if any(base.endswith(f) for f in _EXPERT_BANK_FAMILIES):
            specs[k] = layout.expert_bank_scale() if base != k \
                else layout.expert_bank()
        elif "block_sparse_moe.gate." in base:
            specs[k] = layout.replicated()
        else:
            rest.append(k)
    specs.update(llama_param_specs(rest, layout))
    if shapes is not None and mesh is not None:
        specs = {k: prune_spec_axes(s, shapes[k], mesh)
                 if k in shapes else s for k, s in specs.items()}
    return specs


def _entry_names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, tuple):
        return tuple(entry)
    return (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in dim order."""
    out = []
    for entry in spec:
        out.extend(_entry_names(entry))
    return tuple(out)


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, ProcessMesh):
        return mesh.axis_sizes()
    return dict(mesh)


def prune_spec_axes(spec, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Drop the axis names a dim cannot honor (a degree that does not
    divide it, an entry past the rank; reference: ``prune_spec_axes``)."""
    sizes = _sizes(mesh)
    entries = []
    for dim, entry in enumerate(spec):
        if dim >= len(shape):
            break
        keep, part = [], 1
        for name in _entry_names(entry):
            size = sizes.get(name, 1)
            if size > 1 and shape[dim] % (part * size) == 0:
                keep.append(name)
                part *= size
        entries.append(tuple(keep) if len(keep) > 1
                       else (keep[0] if keep else None))
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def validate_tp_serving(cfg, degree: int, pool_kv_heads: Optional[int]
                        = None) -> None:
    """Every divisibility tp serving needs, at engine construction
    (reference: ``validate_tp_serving``, the same message)."""
    if degree <= 1:
        return
    problems = []
    for name, val in (("num_attention_heads", cfg.num_attention_heads),
                      ("num_key_value_heads", cfg.num_key_value_heads),
                      ("vocab_size", cfg.vocab_size),
                      ("intermediate_size", cfg.intermediate_size)):
        if val % degree:
            problems.append(f"{name}={val}")
    if pool_kv_heads is not None \
            and pool_kv_heads != cfg.num_key_value_heads:
        problems.append(
            f"KV page pool has {pool_kv_heads} kv heads but the model "
            f"config says {cfg.num_key_value_heads}")
    if problems:
        raise ValueError(
            "tensor-parallel serving with tp=%d requires every sharded "
            "dimension to divide by tp; violated: %s.  Pick a tp that "
            "divides the head/vocab/ffn dims (or pad the model)."
            % (degree, ", ".join(problems)))


def validate_cp_serving(cp_degree: int, block_size: int,
                        quantized_kv: bool = False,
                        dense_prefill: bool = False,
                        spec_decode: bool = False) -> None:
    """Every constraint context-parallel serving needs, at engine
    construction (reference: ``validate_cp_serving``, the same messages):
    cp stripes the pool's slot dim, so ``block_size`` must divide by cp;
    int8 pools, the dense prefill and speculative decoding are refused."""
    if cp_degree <= 1:
        return
    if block_size % cp_degree:
        raise ValueError(
            f"context-parallel serving with cp={cp_degree} requires the "
            f"KV page block_size to divide by cp (each chip owns "
            f"block_size/cp slots of every page); got "
            f"block_size={block_size}.  Pick a block_size that divides "
            f"by cp, or lower cp.")
    if quantized_kv:
        raise ValueError(
            f"context-parallel serving (cp={cp_degree}) does not "
            f"support the int8 KV pool: the [phys_pages, Hkv] absmax "
            f"tables are page-global and would diverge across slot "
            f"stripes.  Serve with kv_dtype=None (fp32 pool) under cp.")
    if dense_prefill:
        raise ValueError(
            f"context-parallel serving (cp={cp_degree}) requires the "
            f"chunked/ragged prefill path; the legacy dense prefill "
            f"writes whole pages per chip and cannot stripe.  Construct "
            f"the engine with prefill_chunk_size set (paged prefill).")
    if spec_decode:
        raise ValueError(
            f"context-parallel serving (cp={cp_degree}) does not "
            f"support speculative decoding yet: the draft/verify steps "
            f"bypass the striped scatter.  Disable spec-decode under "
            f"cp.")


def validate_ep_serving(num_experts: int, ep_degree: int,
                        mixed_step: bool = True,
                        dense_prefill: bool = False,
                        spec_decode: bool = False,
                        budgets: Sequence[int] = ()) -> None:
    """Every constraint ep serving needs, at engine construction
    (reference: ``validate_ep_serving``, the same messages)."""
    if ep_degree <= 1:
        return
    if not num_experts:
        raise ValueError(
            f"expert-parallel serving with ep={ep_degree} needs an MoE "
            f"model (num_local_experts on the config): a dense model "
            f"has no expert banks for the ep axis to shard — drop the "
            f"ep mesh axis or serve the Mixtral-family model.")
    if num_experts % ep_degree:
        raise ValueError(
            f"expert-parallel serving with ep={ep_degree} requires the "
            f"expert count to divide by ep (each chip owns E/ep "
            f"experts); got num_local_experts={num_experts}.  Pick an "
            f"ep that divides E, or lower ep.")
    if not mixed_step or dense_prefill:
        raise ValueError(
            f"expert-parallel serving (ep={ep_degree}) requires the "
            f"mixed ragged step: the token->expert all_to_all dispatch "
            f"is fused into the ONE compiled mixed launch, and the "
            f"legacy dense prefill/decode bodies have no ep stripe.  "
            f"Construct the engine with mixed_step=True.")
    if spec_decode:
        raise ValueError(
            f"expert-parallel serving (ep={ep_degree}) does not "
            f"support speculative decoding yet: the draft/verify steps "
            f"bypass the fused MoE dispatch.  Disable spec-decode "
            f"under ep.")
    bad = [b for b in budgets if int(b) % ep_degree]
    if bad:
        raise ValueError(
            f"expert-parallel serving (ep={ep_degree}) stripes each "
            f"compiled token budget over the ep axis, so every budget "
            f"must divide by ep; violated: {bad}.  Adjust the mixed "
            f"budget set (token_budgets) or lower ep.")


class TPContext:
    """One engine's sharded serving context on this rank (reference:
    ``TPContext``): the mesh, the tp axis and degree (compute), the fsdp
    (weight storage), cp (pool slot stripes) and ep (expert banks) axes
    and degrees, the layout and the per-parameter specs (the reference's
    tables, reference layout).  :meth:`bind` joins the mesh's data groups
    (collectively) and gives ``tp_comm`` / ``fsdp_comm`` / ``cp_comm`` /
    ``ep_comm``, this rank's :class:`AxisComm` on each axis (None for a
    degree-1 axis)."""

    def __init__(self, mesh: ProcessMesh, axis: Optional[str], degree: int,
                 layout: SpecLayout, specs: Dict[str, PartitionSpec],
                 fsdp_axis: Optional[str] = None, fsdp_degree: int = 1,
                 cp_axis: Optional[str] = None, cp_degree: int = 1,
                 ep_axis: Optional[str] = None, ep_degree: int = 1):
        self.mesh = mesh
        self.axis = axis
        self.degree = degree
        self.fsdp_axis = fsdp_axis if fsdp_degree > 1 else None
        self.fsdp_degree = fsdp_degree if fsdp_degree > 1 else 1
        self.cp_axis = cp_axis if cp_degree > 1 else None
        self.cp_degree = cp_degree if cp_degree > 1 else 1
        self.ep_axis = ep_axis if ep_degree > 1 else None
        self.ep_degree = ep_degree if ep_degree > 1 else 1
        self.layout = layout
        self.specs = specs
        self.tp_comm: Optional[AxisComm] = None
        self.fsdp_comm: Optional[AxisComm] = None
        self.cp_comm: Optional[AxisComm] = None
        self.ep_comm: Optional[AxisComm] = None
        self.rank: Optional[int] = None
        self._fsdp_bytes: Optional[int] = None
        # the engine's gather of the stored fsdp shards (FsdpParams)
        self.fsdp_params: Optional["FsdpParams"] = None

    def bind(self) -> "TPContext":
        comms = self.mesh.bind()
        self.tp_comm = comms[self.axis] if self.degree > 1 else None
        self.fsdp_comm = comms[self.fsdp_axis] if self.fsdp_axis else None
        self.cp_comm = comms[self.cp_axis] if self.cp_axis else None
        self.ep_comm = comms[self.ep_axis] if self.ep_axis else None
        import torch.distributed as dist
        self.rank = dist.get_rank()
        return self

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (binds first if needed)."""
        if self.rank is None:
            self.bind()
        return self.mesh.coords(self.rank)

    def fsdp_gather_bytes(self, arrays) -> int:
        """Per-rank bytes RECEIVED by the fsdp gathers of one dispatch
        (reference: ``TPContext.fsdp_gather_bytes``; 0 without an fsdp
        axis): for each fsdp-sharded parameter of ``arrays`` (whole
        shapes; numpy or torch), the rank holds ``1/part`` of it and
        receives the other ``fsdp - 1`` fsdp shards of its tp slice.
        Static per engine, cached on the first call."""
        if self.fsdp_axis is None:
            return 0
        if self._fsdp_bytes is not None:
            return self._fsdp_bytes
        sizes = self.mesh.axis_sizes()
        total = 0
        for k, v in arrays.items():
            spec = self.specs.get(k)
            if spec is None:
                continue
            names = spec_axes(spec)
            if self.fsdp_axis not in names:
                continue
            part = 1
            for n in names:
                part *= sizes.get(n, 1)
            item = (v.element_size() if isinstance(v, torch.Tensor)
                    else v.dtype.itemsize)
            nbytes = int(math.prod(tuple(v.shape))) * item
            total += nbytes // part * (sizes[self.fsdp_axis] - 1)
        self._fsdp_bytes = total
        return total

    def collective_bytes(self, cfg, n_tokens: int, n_gather_rows: int,
                         quant_gather: bool = False) -> Dict[str, int]:
        """Per-rank collective payload of ONE sharded dispatch (reference:
        ``TPContext.collective_bytes``, the same formula): ``(2L + 1)``
        sums of ``[n_tokens, hidden]``, one logits all-gather of
        ``[n_gather_rows, V/tp]`` (int8 codes + a 4-byte scale with
        ``quant_gather``); with cp the stripe merge's one all_gather of
        the fp32 ``(o, m, l)`` rows a layer (``"cp_merge"``: ``L ·
        n_tokens · H/tp · (D + 2) · 4`` from each of the other ``cp - 1``
        ranks); with ep the MoE dispatch's two all_to_alls and one
        token-stripe all_gather per layer."""
        if self.degree <= 1:
            out = {"psum": 0, "all_gather": 0}
        else:
            item = 2 if cfg.dtype == "bfloat16" else 4
            shard = n_gather_rows * (cfg.vocab_size // self.degree)
            out = {
                "psum": (2 * cfg.num_hidden_layers + 1) * n_tokens
                * cfg.hidden_size * item,
                "all_gather": shard + 4 if quant_gather else shard * item,
            }
        if self.cp_degree > 1:
            h_local = cfg.num_attention_heads // self.degree
            d = cfg.hidden_size // cfg.num_attention_heads
            out["cp_merge"] = (cfg.num_hidden_layers * n_tokens
                               * h_local * (d + 2) * 4
                               * (self.cp_degree - 1))
        if self.ep_degree > 1:
            item = 2 if cfg.dtype == "bfloat16" else 4
            ep = self.ep_degree
            E = cfg.num_local_experts
            k = cfg.num_experts_per_tok
            L = cfg.num_hidden_layers
            tl = n_tokens // ep
            buf = E * (tl * k) * cfg.hidden_size * item
            out["ep_all_to_all"] = 2 * L * buf * (ep - 1) // ep
            out["ep_all_gather"] = (L * (ep - 1) * tl
                                    * cfg.hidden_size * item)
        return out

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of parameter ``name`` (``full`` in the port's
        layout)."""
        return shard_tensor(full, port_spec(name, self.specs[name]),
                            self.mesh, self.coords)

    def __repr__(self):
        return (f"TPContext(axis={self.axis!r}, degree={self.degree}, "
                f"fsdp_axis={self.fsdp_axis!r}, "
                f"fsdp_degree={self.fsdp_degree}, "
                f"cp_axis={self.cp_axis!r}, cp_degree={self.cp_degree}, "
                f"ep_axis={self.ep_axis!r}, ep_degree={self.ep_degree}, "
                f"mesh={tuple(self.mesh.axis_sizes().items())})")


def full_shapes(model) -> Dict[str, Tuple[int, ...]]:
    """The whole model's parameter shapes: a shard's are recorded by
    :func:`shard_model`, a whole model's are its own."""
    info = getattr(model, "_ptt_shard", None)
    if info is not None:
        return dict(info.full_shapes)
    return {k: tuple(t.shape) for k, t in model.state_dict().items()}


def _layout_for(sizes: Dict[str, int], tp_axis: Optional[str],
                tp_degree: int) -> SpecLayout:
    """The layout of a mesh's axes: each of fsdp, cp and ep named when its
    degree is > 1."""
    def named(ax):
        return ax if sizes.get(ax, 1) > 1 else None
    return SpecLayout(tp_axis=tp_axis if tp_degree > 1 else None,
                      fsdp_axis=named("fsdp"), cp_axis=named("cp"),
                      ep_axis=named("ep"))


def reference_shapes(shapes: Dict[str, Tuple[int, ...]]
                     ) -> Dict[str, Tuple[int, ...]]:
    """The port's parameter shapes in the reference's layout (a 2-D
    Linear weight ``[out, in]`` as ``[in, out]``), which the spec tables
    and their pruning are written for."""
    return {k: (tuple(v)[::-1] if _is_linear_weight(k) and len(v) == 2
                else tuple(v)) for k, v in shapes.items()}


def _specs_for(config, shapes, layout, mesh) -> Dict[str, PartitionSpec]:
    fn = mixtral_param_specs if getattr(config, "num_local_experts", 0) \
        else llama_param_specs
    return fn(shapes.keys(), layout, shapes=reference_shapes(shapes),
              mesh=mesh)


def tp_serving_context(model, mesh, sharding: Optional[ShardingConfig]
                       = None) -> Optional[TPContext]:
    """Resolve an engine's ``mesh``/``sharding`` into a :class:`TPContext`,
    or None when every axis degenerates to 1 (reference:
    ``tp_serving_context``); validates tp divisibility first.  A mesh
    without a tp axis is still a sharded context when it has an fsdp
    (pure fsdp, or fsdp x dp), cp or ep axis; any other axis (``dp``) is
    named by no spec, so weights and pools replicate across it."""
    if sharding is not None and not isinstance(sharding, ShardingConfig):
        raise TypeError("sharding must be a jit.spmd.ShardingConfig; got %r"
                        % type(sharding).__name__)
    cfg = sharding or ShardingConfig(axis="tp")
    pm = as_mesh(mesh) if mesh is not None else None
    sizes = pm.axis_sizes() if pm is not None else {}
    fsdp_deg, cp_deg, ep_deg = (sizes.get(a, 1) for a in ("fsdp", "cp",
                                                           "ep"))
    try:
        pm, axis, deg = resolve_mesh_axis(
            mesh, cfg.axis, cfg.degree, candidates=("tp", "model", "mp"))
    except ValueError:
        if not any(a in sizes for a in ("fsdp", "cp", "ep")):
            raise
        axis, deg = None, 1
    if deg <= 1 and fsdp_deg <= 1 and cp_deg <= 1 and ep_deg <= 1:
        return None
    if deg > 1:
        validate_tp_serving(model.config, deg)
    layout = _layout_for(sizes, axis, deg)
    specs = _specs_for(model.config, full_shapes(model), layout, pm)
    return TPContext(pm, axis if deg > 1 else None, deg, layout, specs,
                     fsdp_axis=layout.fsdp_axis, fsdp_degree=fsdp_deg,
                     cp_axis=layout.cp_axis, cp_degree=cp_deg,
                     ep_axis=layout.ep_axis, ep_degree=ep_deg)


# ---------------------------------------------------------------------------
# cutting a rank's shard
# ---------------------------------------------------------------------------
def _is_linear_weight(name: str) -> bool:
    return (name.endswith("_proj.weight") or name == "lm_head.weight"
            or name.endswith("block_sparse_moe.gate.weight"))


def port_spec(name: str, spec) -> PartitionSpec:
    """``spec`` (reference layout) for the port's tensor ``name``: a 2-D
    Linear weight is ``[out, in]`` here, so its two entries swap."""
    if not _is_linear_weight(name):
        return P(*spec)
    ents = list(spec) + [None] * (2 - len(spec))
    return _trim(P(ents[1], ents[0]))


def _trim(spec) -> PartitionSpec:
    ents = list(spec)
    while ents and ents[-1] is None:
        ents.pop()
    return P(*ents)


def shard_tensor(full: torch.Tensor, spec, mesh: ProcessMesh,
                 coords: Dict[str, int]) -> torch.Tensor:
    """The slice of ``full`` that the rank at ``coords`` holds under
    ``spec`` (port layout): each dim named by axes splits into the
    product of their sizes, major to minor."""
    sizes = mesh.axis_sizes()
    out = full
    for dim, entry in enumerate(spec):
        names = _entry_names(entry)
        if not names:
            continue
        part, idx = 1, 0
        for n in names:
            idx = idx * sizes[n] + coords[n]
            part *= sizes[n]
        if full.shape[dim] % part:
            raise ValueError("dim %d of size %d does not split into %d"
                             % (dim, full.shape[dim], part))
        step = full.shape[dim] // part
        out = out.narrow(dim, idx * step, step)
    return out


@dataclass
class _ShardInfo:
    mesh_sizes: Dict[str, int]
    coords: Dict[str, int]
    full_shapes: Dict[str, Tuple[int, ...]]


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    mod_path, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_path) if mod_path else model
    setattr(mod, leaf, nn.Parameter(value, requires_grad=False))


@torch.no_grad()
def shard_model(model_cls, config, mesh, *, rank: Optional[int] = None,
                device=None, generator: Optional[torch.Generator] = None,
                state: Optional[Dict[str, torch.Tensor]] = None):
    """This rank's shard of ``model_cls(config)``, in eval mode.

    Built parameter by parameter: the model is constructed on ``meta``,
    then each parameter, in the order ``init_weights`` draws them, is made
    whole on ``device`` — drawn from ``generator`` exactly as the
    single-card model draws it (seed 0 on the device when None), or taken
    from ``state`` (the port's names and layouts, e.g.
    ``testing.parity.state_from_paddle_tpu``) — and only this rank's slice
    is kept.  So each shard equals, bit for bit, the slice of the model
    the same seed builds on one card, and at most one whole parameter is
    on the card at a time.

    ``rank`` defaults to this process's ``torch.distributed`` rank.  The
    attention modules report their per-rank head counts (``num_heads``,
    ``num_kv_heads``), which the serving steps read.  Under an fsdp axis a
    parameter whose spec names it is stored as its ``fsdp x tp`` slice;
    the engine gathers the tp compute shard back at each dispatch
    (:class:`FsdpParams`)."""
    from ..core.device import resolve_device
    from ..models.llama import init_parameter
    pm = as_mesh(mesh)
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank() if dist.is_initialized() else 0
    coords = pm.coords(rank)
    model = model_cls(config, device="meta")
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    sizes = pm.axis_sizes()
    tp = sizes.get("tp", 1)
    if tp > 1:
        validate_tp_serving(config, tp)
    if "ep" in sizes and sizes["ep"] > 1:
        validate_ep_serving(getattr(config, "num_local_experts", 0),
                            sizes["ep"])
    specs = _specs_for(config, shapes, _layout_for(sizes, "tp", tp), pm)
    dev = resolve_device(device)
    dtype = config.torch_dtype
    if state is None and generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    for name, p in list(model.named_parameters()):
        if state is None:
            full = torch.empty(p.shape, dtype=dtype, device=dev)
            init_parameter(name, full, config.initializer_range, generator)
        else:
            full = state[name].to(device=dev, dtype=p.dtype)
        piece = shard_tensor(full, port_spec(name, specs[name]), pm, coords)
        _set_param(model, name, piece.contiguous().clone())
        del full
    for mod in model.modules():
        if hasattr(mod, "num_kv_heads") and hasattr(mod, "q_proj"):
            mod.num_heads //= tp
            mod.num_kv_heads //= tp
    model._ptt_shard = _ShardInfo(sizes, coords, shapes)
    model.eval()
    return model


# ---------------------------------------------------------------------------
# the fsdp prologue: stored shards back to the tp compute shard
# ---------------------------------------------------------------------------
def _fsdp_dim(spec, fsdp_axis: str) -> Optional[int]:
    """The dim a (port layout) spec shards over ``fsdp_axis``, or None.
    The families name fsdp alone on a dim; a dim that splits over fsdp
    and another axis together cannot be gathered over fsdp alone."""
    for dim, entry in enumerate(spec):
        names = _entry_names(entry)
        if fsdp_axis in names:
            if len(names) > 1:
                raise ValueError("spec %s splits dim %d over %s together; "
                                 "the fsdp gather takes fsdp alone on a "
                                 "dim" % (spec, dim, names))
            return dim
    return None


def fsdp_gather(x: torch.Tensor, spec, comm: AxisComm) -> torch.Tensor:
    """Undo only the fsdp storage shard of ``x`` (reference:
    ``fsdp_gather``): the rank's ``fsdp x tp`` slice under the port-layout
    ``spec`` back to its tp compute shard, one all-gather over the fsdp
    ranks along the dim the spec names fsdp on."""
    dim = _fsdp_dim(spec, comm.name)
    if dim is None:
        return x
    return comm.all_gather(x, dim)


def gather_spec_axes(x: torch.Tensor, spec, comms: Dict[str, AxisComm],
                     op: str = "all_gather") -> torch.Tensor:
    """The whole value of a placed slice ``x`` (reference:
    ``gather_spec_axes``; ``spec`` in the port's layout): one all-gather
    along each dim whose entry names an axis, the minor name of a tuple
    entry first, so every block lands at its global offset.  ``op`` names
    the calls in ``STATS``."""
    for dim, entry in enumerate(spec):
        for name in reversed(_entry_names(entry)):
            x = comms[name].all_gather(x, dim, op=op)
    return x


def scatter_spec_axes(g: torch.Tensor, spec, comms: Dict[str, AxisComm],
                      op: str = "reduce_scatter") -> torch.Tensor:
    """The inverse of :func:`gather_spec_axes` for a gradient: one
    reduce-scatter along each spec-named dim, the major name of a tuple
    entry first (the reference's tiled ``psum_scatter`` per name), so
    this rank keeps its placed slice of the sum over those axes."""
    for dim, entry in enumerate(spec):
        for name in _entry_names(entry):
            c = comms[name]
            moved = g.movedim(dim, 0)
            rows = moved.shape[0] // c.size
            row = c.reduce_scatter(moved.reshape(c.size, -1), op)
            g = row.view((rows,) + tuple(moved.shape[1:])).movedim(0, dim)
    return g


def unslice(rows: torch.Tensor, at: int, shape, dim: int,
            dst: torch.Tensor) -> torch.Tensor:
    """Lay out one tensor's fsdp slices, gathered as ``rows[g, at:at +
    numel]`` from fsdp rank ``g`` (each of ``shape``), into ``dst``, the
    whole tensor (``shape`` with ``dim`` times the fsdp degree), in
    place."""
    F = rows.shape[0]
    src = rows[:, at:at + math.prod(shape)].view((F,) + tuple(shape))
    dst.view(tuple(shape[:dim]) + (F, shape[dim]) + tuple(shape[dim + 1:])) \
        .copy_(src.movedim(0, dim))
    return dst


def fsdp_groups(model, specs: Dict[str, PartitionSpec], fsdp_axis: str
                ) -> Dict[object, List[Tuple[str, torch.Tensor, int]]]:
    """The fsdp-sharded parameters of a decoder-stack model by module group
    (``"embed"``, ``"norm"``, ``"head"``, then each layer's index), each
    as ``(name, parameter, fsdp dim)`` in the module's parameter order;
    ``specs`` in the port's layout, by name (a name it lacks is left out).
    The fsdp serving engine (:class:`FsdpParams`) packs and gathers a
    group at a time in this order, and the 2-D ``TrainStep`` stores its
    slices so, for the engine to adopt them."""
    from ..models.llama import inner_model
    stack = inner_model(model)
    names = {id(p): n for n, p in model.named_parameters() if n in specs}
    mods = {"embed": stack.embed_tokens, "norm": stack.norm,
            "head": model.lm_head}
    mods.update(enumerate(stack.layers))
    out: Dict[object, List[Tuple[str, torch.Tensor, int]]] = {}
    for key, mod in mods.items():
        if mod is None:
            continue
        items = []
        for p in mod.parameters():
            n = names.get(id(p))
            if n is None:
                continue
            dim = _fsdp_dim(specs[n], fsdp_axis)
            if dim is not None:
                items.append((n, p, dim))
        out[key] = items
    return out


def _packed(items) -> Optional[torch.Tensor]:
    """The one buffer ``items``' tensors already lie in back to back, in
    order (a 2-D ``TrainStep``'s stored slices), or None."""
    if not items:
        return None
    first = items[0][1].data
    base, size = first.data_ptr(), first.element_size()
    storage = first.untyped_storage().data_ptr()
    off = 0
    for _, p, _ in items:
        t = p.data
        if not t.is_contiguous() or t.dtype != first.dtype \
                or t.untyped_storage().data_ptr() != storage \
                or t.data_ptr() != base + off * size:
            return None
        off += t.numel()
    return first.as_strided((off,), (1,), first.storage_offset())


class _FsdpGroup:
    """The fsdp-sharded parameters of one module group (the embedding, a
    decoder layer, the final norm, the LM head), their stored pieces held
    back to back in one flat buffer."""

    def __init__(self, params, flat):
        self.params = params          # [(param, dim, piece shape, offset)]
        self.flat = flat

    @property
    def numel(self) -> int:
        return self.flat.numel()


class FsdpParams:
    """The serving prologue under an fsdp axis (reference:
    ``_wrap_sharded``'s fsdp gather), one group at a time
    (:func:`fsdp_groups`).

    At construction each group's stored pieces are moved into ONE flat
    buffer (the parameters become views of it), so a group crosses the
    fsdp ranks in one all-gather; pieces that already lie so (a 2-D
    ``TrainStep``'s, the train -> serve handoff) are adopted as they are,
    with no copy (``adopted`` counts them).  :meth:`gather` (a context
    manager) gathers a group into a wire scratch, lays each parameter's tp compute
    shard out in a compute scratch, points the parameters at it for the
    duration and back at their pieces after: a rank holds its stored
    shards plus one group's compute shard, never a second model.  The two
    scratches are reused by every group.  The bytes received a dispatch
    (every group once) are ``TPContext.fsdp_gather_bytes``.  A model with
    tied embeddings keeps its gathered table from ``"embed"`` to
    ``"head"`` in a scratch of its own.  ``skip``: parameter names another
    store stands in for (the engine's int8 weight tree, which gathers its
    own codes), left out of the groups."""

    def __init__(self, model, tp: TPContext, skip: Iterable[str] = ()):
        self.comm = tp.fsdp_comm
        F = self.comm.size
        skip = set(skip)
        self.tied = model.lm_head is None
        dtypes = {p.dtype for n, p in model.named_parameters()
                  if n not in skip}
        if len(dtypes) != 1:
            raise ValueError("the fsdp gather packs one dtype; the model "
                             "holds %s" % sorted(map(str, dtypes)))
        dtype = dtypes.pop()
        specs = {n: port_spec(n, tp.specs[n]) for n, _ in
                 model.named_parameters() if n not in skip}
        self.groups: Dict[object, _FsdpGroup] = {}
        self.adopted = 0
        dev = next(model.parameters()).device
        with torch.no_grad():
            for key, found in fsdp_groups(model, specs,
                                          tp.fsdp_axis).items():
                items, off = [], 0
                for _n, p, dim in found:
                    items.append((p, dim, tuple(p.shape), off))
                    off += p.numel()
                flat = _packed(found)
                if flat is not None:
                    # a 2-D train step's stored slices: adopted, no copy
                    self.adopted += len(items)
                else:
                    flat = torch.empty(off, dtype=dtype, device=dev)
                    for p, _d, shape, o in items:
                        flat[o:o + p.numel()].copy_(p.reshape(-1))
                for p, _d, shape, o in items:
                    p.data = flat[o:o + p.numel()].view(shape)
                self.groups[key] = _FsdpGroup(items, flat)
        big = max(g.numel for g in self.groups.values())
        self._wire = torch.empty(F * big, dtype=dtype, device=dev)
        self._scratch = torch.empty(F * big, dtype=dtype, device=dev)
        self._embed_scratch = (torch.empty(
            F * self.groups["embed"].numel, dtype=dtype, device=dev)
            if self.tied else None)
        self.gathers = 0

    def gathered_bytes(self) -> int:
        """Bytes one dispatch receives (every group once)."""
        F = self.comm.size
        return sum(g.flat.numel() * g.flat.element_size() * (F - 1)
                   for g in self.groups.values())

    def _fill(self, g: _FsdpGroup, scratch: torch.Tensor) -> None:
        F = self.comm.size
        n = g.numel
        if n == 0:
            return
        wire = self._wire[:F * n].view(F, n)
        self.comm.all_gather_rows(wire, g.flat)
        self.gathers += 1
        at = 0
        for p, dim, shape, off in g.params:
            k = math.prod(shape)
            full = shape[:dim] + (F * shape[dim],) + shape[dim + 1:]
            p.data = unslice(wire, off, shape, dim,
                             scratch[at:at + F * k]).view(full)
            at += F * k

    def _restore(self, g: _FsdpGroup) -> None:
        for p, _dim, shape, off in g.params:
            p.data = g.flat[off:off + math.prod(shape)].view(shape)

    @contextlib.contextmanager
    def gather(self, key):
        """Group ``key`` (``"embed"``, a layer index, ``"norm"``,
        ``"head"``) at its tp compute shard for the ``with`` block."""
        if self.tied and key in ("embed", "head"):
            g = self.groups["embed"]
            if key == "embed":
                self._fill(g, self._embed_scratch)
                yield
                return
            try:
                yield
            finally:
                self._restore(g)
            return
        g = self.groups.get(key)
        if g is None:
            yield
            return
        self._fill(g, self._scratch)
        try:
            yield
        finally:
            self._restore(g)


# ---------------------------------------------------------------------------
# the helpers of the sharded steps
# ---------------------------------------------------------------------------
def tp_embed(table_local: torch.Tensor, tokens: torch.Tensor,
             comm: AxisComm) -> torch.Tensor:
    """Vocab-parallel embedding (reference: ``tp_embed``): this rank's
    ``[V/tp, h]`` rows looked up where the token falls in them, zeros
    elsewhere, then one sum over tp — exact, each token's row lives on
    one rank."""
    vs = table_local.shape[0]
    local = tokens.long() - comm.index * vs
    ok = (local >= 0) & (local < vs)
    e = table_local[local.clamp(0, vs - 1)]
    e = torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                  device=e.device))
    return comm.all_reduce(e)


def tp_gather_logits(logits_local: torch.Tensor,
                     comm: AxisComm) -> torch.Tensor:
    """All-gather the ``[*, V/tp]`` vocab shards into ``[*, V]`` (exact:
    rank order is vocab order; reference: ``tp_gather_logits``)."""
    return comm.all_gather(logits_local, logits_local.ndim - 1)


def tp_gather_logits_q8(logits_local: torch.Tensor,
                        comm: AxisComm) -> torch.Tensor:
    """The int8 logits all-gather (reference: ``tp_gather_logits_q8``):
    each rank quantizes its shard with one absmax scale, the gather moves
    the int8 codes and the 4-byte scales, and every rank dequantizes each
    shard with its own scale.  Not exact: logits within ``absmax/127``
    of each other can swap."""
    from ..quantization.functional import (dequantize_symmetric,
                                           quantize_symmetric)
    x = logits_local.to(torch.float32)
    s = x.abs().amax()
    q = quantize_symmetric(x, s).to(torch.int8)
    gq = comm.all_gather(q, q.ndim - 1)
    gs = comm.all_gather(s.reshape(1), 0)                  # [tp]
    tp = gs.shape[0]
    lead, V = tuple(gq.shape[:-1]), gq.shape[-1]
    out = dequantize_symmetric(gq.reshape(lead + (tp, V // tp)),
                               gs[:, None])
    return out.reshape(lead + (V,)).to(logits_local.dtype)
