"""``paddle.amp.debugging`` (counterpart of
``paddle_tpu/amp/debugging.py``): the tensor checker, operator
statistics by dtype, ``check_numerics`` and ``compare_accuracy``.

Everything hooks the one door every API op goes through
(``core.dispatch.apply_op``'s ``_amp_debug_hook`` slot), which sees each
op's name and outputs.  Statistics dumps are jsonl (one record an op
output), and ``compare_accuracy`` writes a csv report."""
from __future__ import annotations

import contextlib
import json
import os
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

import torch

from ..core import dispatch as _dispatch

__all__ = ["DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics",
           "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "compare_accuracy"]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2        # dump stats for every op (the compare source)


class TensorCheckerConfig:
    """enable: master switch; debug_mode: abort / warn / dump-all;
    output_dir: when set, per-op stats stream to
    ``<output_dir>/tensor_stats.jsonl`` (the compare_accuracy input);
    checked_op_list / skipped_op_list: name filters."""

    def __init__(self, enable: bool,
                 debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir: Optional[str] = None,
                 checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=None):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        self._file = None
        self._step = 0

    def _want(self, name: str) -> bool:
        base = name.split("::")[0]
        if base in self.skipped_op_list:
            return False
        if self.checked_op_list:
            return base in self.checked_op_list
        return True

    def _sink(self):
        if self.output_dir is None:
            return None
        if self._file is None:
            os.makedirs(self.output_dir, exist_ok=True)
            self._file = open(
                os.path.join(self.output_dir, "tensor_stats.jsonl"), "a")
        return self._file


def _host64(v) -> np.ndarray:
    """``v`` (a torch tensor or array-like) as a float64 numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_complex():
            v = v.real
        return v.to(torch.float64).cpu().numpy()
    return np.asarray(v, np.float64)


def _tensor_stats(v) -> Dict:
    a = _host64(v)
    finite = np.isfinite(a)
    return {
        "min": float(a[finite].min()) if finite.any() else None,
        "max": float(a[finite].max()) if finite.any() else None,
        "mean": float(a[finite].mean()) if finite.any() else None,
        "num_nan": int(np.isnan(a).sum()),
        "num_inf": int(np.isinf(a).sum()),
        "numel": int(a.size),
    }


def check_numerics(tensor, op_type: str = "tensor", var_name: str = "",
                   debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT):
    """One tensor's check: ``(num_nan, num_inf, num_zero)`` as tensors;
    aborts (``FloatingPointError``) on a NaN or Inf in the abort mode."""
    from ..core.tensor import Tensor
    a = _host64(tensor._value if isinstance(tensor, Tensor) else tensor)
    num_nan = int(np.isnan(a).sum())
    num_inf = int(np.isinf(a).sum())
    num_zero = int((a == 0).sum())
    if num_nan or num_inf:
        msg = (f"[check_numerics] op={op_type} var={var_name}: "
               f"{num_nan} nan, {num_inf} inf in {a.size} elements")
        if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
            raise FloatingPointError(msg)
        print("WARNING:", msg)
    return (Tensor(np.array(num_nan)), Tensor(np.array(num_inf)),
            Tensor(np.array(num_zero)))


_ACTIVE_CONFIG: List[Optional[TensorCheckerConfig]] = [None]


def _dtype_name(d) -> str:
    """The dtype's numpy-style name (``float32``), as the reference
    writes it."""
    return str(d).replace("torch.", "")


def _checker_hook(name: str, out_vals):
    cfg = _ACTIVE_CONFIG[0]
    if cfg is None or not cfg._want(name):
        return
    for i, v in enumerate(out_vals):
        if not isinstance(v, torch.Tensor) or not (
                v.is_floating_point() or v.is_complex()):
            continue
        stats = _tensor_stats(v)
        sink = cfg._sink()
        if sink is not None and cfg.debug_mode == DebugMode.CHECK_ALL:
            rec = {"op": name, "out": i,
                   "dtype": _dtype_name(v.dtype), **stats}
            sink.write(json.dumps(rec) + "\n")
        if stats["num_nan"] or stats["num_inf"]:
            msg = (f"[tensor_checker] op={name} output#{i} "
                   f"dtype={_dtype_name(v.dtype)}: {stats['num_nan']} nan, "
                   f"{stats['num_inf']} inf "
                   f"(finite min={stats['min']}, max={stats['max']})")
            if sink is not None:
                sink.write(json.dumps(
                    {"op": name, "out": i, "event": "nonfinite",
                     **stats}) + "\n")
                sink.flush()
            if cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                raise FloatingPointError(msg)
            print("WARNING:", msg)


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Install the per-op numeric checker at the dispatch door."""
    if not checker_config.enable:
        return
    _ACTIVE_CONFIG[0] = checker_config
    _dispatch._amp_debug_hook[0] = _compose_hooks()


def disable_tensor_checker():
    cfg = _ACTIVE_CONFIG[0]
    if cfg is not None and cfg._file is not None:
        cfg._file.close()
        cfg._file = None
    _ACTIVE_CONFIG[0] = None
    if _OP_STATS[0] is None:
        _dispatch._amp_debug_hook[0] = None


# ---------------------------------------------------------------------------
# operator stats collection
# ---------------------------------------------------------------------------
_OP_STATS: List[Optional[Dict[str, List[int]]]] = [None]


def _stats_hook(name: str, out_vals):
    table = _OP_STATS[0]
    if table is None:
        return
    base = name.split("::")[0]
    row = table.setdefault(base, [0, 0, 0, 0])
    slot = 3                      # other (no float output)
    for v in out_vals:
        d = getattr(v, "dtype", None)
        if d == torch.float16:
            slot = 0
            break
        if d == torch.bfloat16:
            slot = 1
            break
        if d == torch.float32:
            slot = 2
            break
    row[slot] += 1


def enable_operator_stats_collection():
    """Start counting dispatched ops by compute dtype (fp16 / bf16 / fp32
    / other)."""
    _OP_STATS[0] = {}
    _dispatch._amp_debug_hook[0] = _compose_hooks()


def _compose_hooks():
    def hook(name, out_vals):
        if _OP_STATS[0] is not None:
            _stats_hook(name, out_vals)
        if _ACTIVE_CONFIG[0] is not None:
            _checker_hook(name, out_vals)
    return hook


def _print_operator_stats(table: Dict[str, List[int]]):
    """The <fp16, bf16, fp32, other> table."""
    print("<{:-^120}>".format(" op list "))
    head = "{:-^40}|{:-^17}|{:-^17}|{:-^17}|{:-^17}".format(
        " Op Name ", " FP16 Calls ", " BF16 Calls ", " FP32 Calls ",
        " Other Calls ")
    print(head)
    for op, (f16, b16, f32, other) in sorted(table.items()):
        print(f"  {op:<38}|  {f16:<15}|  {b16:<15}|  {f32:<15}|"
              f"  {other:<15}")
    print("<{:-^120}>".format(""))


def disable_operator_stats_collection():
    """Stop counting and print the table."""
    table = _OP_STATS[0]
    if table is None:
        return
    _print_operator_stats(table)
    _OP_STATS[0] = None
    if _ACTIVE_CONFIG[0] is None:
        _dispatch._amp_debug_hook[0] = None


@contextlib.contextmanager
def collect_operator_stats():
    """Operator statistics over the ``with`` block."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def get_operator_stats() -> Dict[str, List[int]]:
    """The raw counts ``{op: [fp16, bf16, fp32, other]}``."""
    return dict(_OP_STATS[0] or {})


# ---------------------------------------------------------------------------
# run-vs-run accuracy compare
# ---------------------------------------------------------------------------
def compare_accuracy(dump_path: str, another_dump_path: str,
                     output_filename: str, loss_scale: float = 1,
                     dump_all_tensors: bool = False):
    """Compare two CHECK_ALL statistics dumps op by op and write a csv
    report of the diverging ops (NaN/Inf in one run only, or a relative
    mean drift above 0.1); returns the flagged rows."""
    def load(path):
        f = os.path.join(path, "tensor_stats.jsonl")
        recs = {}
        if os.path.exists(f):
            with open(f) as fh:
                for line in fh:
                    r = json.loads(line)
                    if r.get("event") == "nonfinite":
                        continue
                    recs.setdefault((r["op"], r["out"]), []).append(r)
        return recs

    a, b = load(dump_path), load(another_dump_path)
    rows = []
    for key in sorted(set(a) | set(b)):
        ra = a.get(key, [])
        rb = b.get(key, [])
        if not ra or not rb:
            rows.append({"op": key[0], "out": key[1],
                         "issue": "only in one run"})
            continue
        for i, (x, y) in enumerate(zip(ra, rb)):
            bad_x = x["num_nan"] or x["num_inf"]
            bad_y = y["num_nan"] or y["num_inf"]
            if bool(bad_x) != bool(bad_y):
                rows.append({"op": key[0], "out": key[1], "call": i,
                             "issue": "nonfinite in one run",
                             "a": (x["num_nan"], x["num_inf"]),
                             "b": (y["num_nan"], y["num_inf"])})
                continue
            ma, mb = x.get("mean"), y.get("mean")
            if ma is not None and mb is not None:
                denom = max(abs(ma), abs(mb), 1e-10)
                drift = abs(ma - mb) / denom
                if drift > 0.1:
                    rows.append({"op": key[0], "out": key[1], "call": i,
                                 "issue": f"mean drift {drift:.3f}",
                                 "a": ma, "b": mb})
    with open(output_filename, "w") as f:
        f.write("op,out,call,issue,a,b\n")
        for r in rows:
            f.write(f"{r['op']},{r['out']},{r.get('call', '')},"
                    f"\"{r['issue']}\",{r.get('a', '')},"
                    f"{r.get('b', '')}\n")
    return rows


def check_layer_numerics(func):
    """A decorator checking a layer forward's inputs and outputs for NaN
    and Inf: ``FloatingPointError`` names the offending one."""
    import functools

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        from ..core.tensor import Tensor as _T

        def _chk(t, what):
            if isinstance(t, _T):
                v = t._value
                if v.is_floating_point() and \
                        not bool(torch.isfinite(v).all()):
                    raise FloatingPointError(
                        f"{type(self).__name__}.{func.__name__}: "
                        f"non-finite values in {what}")
        for i, a in enumerate(args):
            _chk(a, f"input {i}")
        out = func(self, *args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else [out]
        for i, o in enumerate(outs):
            _chk(o, f"output {i}")
        return out

    return wrapper


__all__.append("check_layer_numerics")
