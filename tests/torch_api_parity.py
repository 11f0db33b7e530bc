"""Helpers of the paddle-API parity tests (``test_torch_api_*.py``): run
one op or callable on both packages from the same numpy inputs and
compare outputs, dtypes and gradients."""
import zlib

import numpy as np

import paddle_tpu as R
import paddle_tpu_torch as P


def seed_of(case_id: str) -> int:
    return zlib.crc32(case_id.encode()) % (2 ** 31)


def _convert(v, pkg, leaves, grad=True):
    if isinstance(v, np.ndarray):
        inexact = grad and v.dtype.kind in "fc"
        t = pkg.to_tensor(v, stop_gradient=not inexact)
        if inexact and v.dtype.kind == "f":
            leaves.append(t)
        return t
    if isinstance(v, list) and v and all(isinstance(x, np.ndarray)
                                         for x in v):
        return [_convert(x, pkg, leaves, grad) for x in v]
    return v


def _flat(out):
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res += _flat(o)
        return res
    return [out]


def _is_tensor(t):
    return isinstance(t, (R.Tensor, P.Tensor))


def _float(t):
    return _is_tensor(t) and np.dtype(t.numpy().dtype).kind == "f"


def run_one(pkg, fn, values, kw_values, cot_seed, grad=True):
    """Call ``fn(*args, **kwargs)`` on ``pkg``'s tensors made from the
    numpy ``values``; then the gradient of ``sum(out * c)`` over every
    float output (``c`` seeded) with respect to every float input."""
    leaves = []
    args = [_convert(v, pkg, leaves, grad) for v in values]
    kwargs = {k: _convert(v, pkg, leaves, grad)
              for k, v in kw_values.items()}
    out = fn(pkg)(*args, **kwargs)
    grads = None
    diff = [o for o in _flat(out) if _float(o) and not o.stop_gradient]
    if grad and diff and leaves:
        rng = np.random.RandomState(cot_seed)
        loss = None
        for o in diff:
            c = pkg.to_tensor(np.asarray(rng.randn(*o.shape)).astype(
                np.dtype(o.numpy().dtype)))
            term = pkg.sum(o * c)
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [None if t.grad is None else t.grad.numpy()
                 for t in leaves]
    return out, grads


class _Untraceable(Exception):
    pass


def _mark(v, leaves, grad):
    if isinstance(v, np.ndarray):
        if grad and v.dtype.kind == "f":
            leaves.append(v)
            return ("leaf", len(leaves) - 1)
        return ("const", v)
    if isinstance(v, list) and v and all(isinstance(x, np.ndarray)
                                         for x in v):
        return ("list", [_mark(x, leaves, grad) for x in v])
    return ("py", v)


def _build(m, lv):
    kind, p = m
    if kind == "leaf":
        return R.Tensor(lv[p])
    if kind == "const":
        return R.to_tensor(p)
    if kind == "list":
        return [_build(x, lv) for x in p]
    return p


def _depends(jaxpr):
    """Which outputs of ``jaxpr`` depend on its inputs (an equation's
    outputs do when any of its inputs does)."""
    dep = set(map(id, jaxpr.invars))
    for eqn in jaxpr.eqns:
        if any(id(v) in dep for v in eqn.invars if not hasattr(v, "val")):
            dep.update(map(id, eqn.outvars))
    return [id(v) in dep for v in jaxpr.outvars]


def run_reference_traced(fn, values, kw_values, cot_seed, grad=True):
    """:func:`run_one` for the reference, with its forward and the VJP of
    ``sum(out * c)`` compiled as one program (``jax.jit``) instead of its
    eager tape's per-primitive compiles; the same outputs, gradients and
    ``stop_gradient`` flags (the eager tape's rule: an inexact output
    needs grad when a float input does and the op went through the
    reference's ``apply_op``, or depends on such an input).  Raises
    :class:`_Untraceable` for an op that computes on the host or has
    non-tensor outputs."""
    import jax
    leaves = []
    a_spec = [_mark(v, leaves, grad) for v in values]
    k_spec = {k: _mark(v, leaves, grad) for k, v in kw_values.items()}
    structure = []

    def f(*lv):
        out = fn(R)(*[_build(m, lv) for m in a_spec],
                    **{k: _build(m, lv) for k, m in k_spec.items()})
        flat = _flat(out)
        if not flat or not all(isinstance(o, R.Tensor) for o in flat):
            raise _Untraceable(name_of(fn))
        structure[:] = [out]
        return tuple(o._value for o in flat)

    from paddle_tpu.core import dispatch as ref_dispatch
    gen = R.ops.random.default_generator()
    key = gen._key
    hook = ref_dispatch._op_profile_hook[0]
    dispatched = []
    # the reference records a tape node (an output that needs grad) for
    # an op that goes through its apply_op; its profile hook sees those
    ref_dispatch._op_profile_hook[0] = lambda *a: dispatched.append(a[0])
    try:
        closed = jax.make_jaxpr(f)(*leaves)
    except _Untraceable:
        raise
    except Exception as e:
        raise _Untraceable(repr(e)[:200])
    finally:
        ref_dispatch._op_profile_hook[0] = hook
        if gen._key is not key:   # a draw inside the trace: undo it
            gen._key = key
    avals = closed.out_avals
    dep = _depends(closed.jaxpr)
    # a complex input needs grad in the eager run too (no float leaf)
    needs = leaves or any(getattr(v, "dtype", None) is not None
                          and np.dtype(v.dtype).kind == "c"
                          for v in list(values) + list(kw_values.values()))
    flags = [not (grad and needs and (d or dispatched)
                  and np.dtype(a.dtype).kind in "fc")
             for a, d in zip(avals, dep)]
    diff = [i for i, a in enumerate(avals)
            if not flags[i] and np.dtype(a.dtype).kind == "f"]
    rng = np.random.RandomState(cot_seed)
    cots = {i: np.asarray(rng.randn(*avals[i].shape)).astype(
        np.dtype(avals[i].dtype)) for i in diff}

    def program(*lv):
        outs, vjp = jax.vjp(f, *lv)
        if not diff:
            return outs, None
        ct = tuple(cots[i] if i in cots else np.zeros(
            a.shape, jax.dtypes.float0 if np.dtype(a.dtype).kind not in
            "fc" else a.dtype) for i, a in enumerate(avals))
        return outs, vjp(ct)

    outs, grads = jax.jit(program)(*leaves)
    wrapped = []
    for v, stop in zip(outs, flags):
        t = R.Tensor._from_value(v)
        t.stop_gradient = stop
        wrapped.append(t)
    result = wrapped[0] if len(wrapped) == 1 and not isinstance(
        structure[0], (list, tuple)) else wrapped
    if not (diff and leaves):
        return result, None
    return result, [np.asarray(g) for g in grads]


def name_of(fn):
    return getattr(fn, "__name__", "op")


def run_both(name, makers, kwargs, seed, grad=True):
    """The op ``name`` on both packages from the same seeded inputs:
    ``(reference (out, grads), port (out, grads))``.  The reference runs
    traced (:func:`run_reference_traced`) where it can, else eagerly."""
    rng = np.random.RandomState(seed)
    values = [m(rng) for m in makers]
    kw = {k: (v(rng) if callable(v) else v) for k, v in kwargs.items()}
    get = lambda p: resolve(p, name)  # noqa: E731
    try:
        ref = run_reference_traced(get, values, kw, seed + 1, grad)
    except _Untraceable:
        ref = run_one(R, get, values, kw, seed + 1, grad)
    return ref, run_one(P, get, values, kw, seed + 1, grad)


def resolve(pkg, dotted):
    """``pkg.<dotted>`` (``"nn.functional.relu"``)."""
    obj = pkg
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def dtype_name(t) -> str:
    if isinstance(t, P.Tensor):
        return P.core.dtypes.dtype_name(t.dtype)
    return str(np.dtype(t.dtype))


def assert_close(got, want, tol, what=""):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(got.astype(want.dtype), want, rtol=tol,
                                   atol=tol, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def compare_outputs(ref, port, fwd_tol, grad_tol):
    (r_out, r_grads), (p_out, p_grads) = ref, port
    rf, pf = _flat(r_out), _flat(p_out)
    assert len(rf) == len(pf), (len(rf), len(pf))
    for i, (a, b) in enumerate(zip(rf, pf)):
        if _is_tensor(a):
            assert _is_tensor(b), (i, type(b))
            assert dtype_name(b) == dtype_name(a), (i, dtype_name(b),
                                                    dtype_name(a))
            assert b.stop_gradient == a.stop_gradient, i
            assert_close(b.numpy(), a.numpy(), fwd_tol, "output %d" % i)
        else:
            assert b == a, (i, b, a)
    assert (r_grads is None) == (p_grads is None), (r_grads, p_grads)
    if r_grads is not None:
        for i, (a, b) in enumerate(zip(r_grads, p_grads)):
            if a is None or b is None:
                # the port keeps an all-zero gradient where the reference
                # has none (or the other way round)
                z = a if b is None else b
                assert z is None or not np.any(z), i
                continue
            assert_close(b, a, grad_tol, "grad %d" % i)


def run_cases(cases, check):
    """``check(case)`` for each case; fails listing every case that
    failed (its id and error), not only the first."""
    bad = []
    for case in cases:
        try:
            check(case)
        except Exception as e:  # collected and reported below
            bad.append("%s: %s: %s" % (case[0], type(e).__name__,
                                       str(e).splitlines()[:3]))
    assert not bad, "\n".join(bad)


def compare_scaled(ref, port, tol):
    """:func:`compare_outputs` with each float output and gradient held to
    ``tol`` of its largest magnitude (``max|got - want| <= tol *
    max|want|``); integer outputs equal, dtypes and ``stop_gradient``
    flags the reference's."""
    (r_out, r_grads), (p_out, p_grads) = ref, port
    rf, pf = _flat(r_out), _flat(p_out)
    assert len(rf) == len(pf), (len(rf), len(pf))

    def close(got, want, what):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, (what, got.shape, want.shape)
        if want.dtype.kind in "fc":
            scale = max(float(np.nanmax(np.abs(want))) if want.size else 0.0,
                        1e-30)
            err = float(np.nanmax(np.abs(got.astype(np.float64)
                                         - want.astype(np.float64)))) \
                if want.size else 0.0
            assert np.array_equal(np.isnan(got), np.isnan(want)), what
            assert err <= tol * scale, (what, err, scale)
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)

    for i, (a, b) in enumerate(zip(rf, pf)):
        if _is_tensor(a):
            assert _is_tensor(b), (i, type(b))
            assert dtype_name(b) == dtype_name(a), (i, dtype_name(b),
                                                    dtype_name(a))
            assert b.stop_gradient == a.stop_gradient, i
            close(b.numpy(), a.numpy(), "output %d" % i)
        else:
            assert b == a, (i, b, a)
    assert (r_grads is None) == (p_grads is None), (r_grads, p_grads)
    for i, (a, b) in enumerate(zip(r_grads or [], p_grads or [])):
        if a is None or b is None:
            z = a if b is None else b
            assert z is None or not np.any(z), i
            continue
        close(b, a, "grad %d" % i)


def run_layers(ref_layer, port_layer, makers, seed, grad=True):
    """``ref_layer`` and ``port_layer`` (the same weights) on the same
    seeded inputs: the reference traced (:func:`run_reference_traced`)
    where it can, else eagerly; outputs and the inputs' gradients."""
    rng = np.random.RandomState(seed)
    values = [m(rng) for m in makers]
    get = lambda p: ref_layer if p is R else port_layer  # noqa: E731
    try:
        ref = run_reference_traced(get, values, {}, seed + 1, grad)
    except _Untraceable:
        ref = run_one(R, get, values, {}, seed + 1, grad)
    return ref, run_one(P, get, values, {}, seed + 1, grad)


def carried(ref_layer, port_layer):
    """``port_layer`` with ``ref_layer``'s state, every key matched."""
    from paddle_tpu_torch.testing.parity import api_state_from_paddle_tpu
    state = {k: np.asarray(v.numpy())
             for k, v in ref_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(
        api_state_from_paddle_tpu(state))
    assert not missing and not unexpected, (missing, unexpected)
    return port_layer
