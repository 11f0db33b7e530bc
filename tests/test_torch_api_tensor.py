"""The API's eager Tensor and its autograd, port against reference on the
CPU: each scenario runs on both packages and returns what it observed
(values, dtypes, ``stop_gradient`` flags, gradients, errors), which must
agree case by case.  Retargets ``tests/test_tensor.py`` and
``tests/test_autograd.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core import dtypes as pdt
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def dname(pk, t):
    if pk is P:
        return pdt.dtype_name(t.dtype)
    return str(np.dtype(t.dtype))


def arr(t):
    return None if t is None else np.asarray(t.numpy(), np.float64)


def raises(fn):
    try:
        fn()
    except Exception as e:  # the class name is compared across packages
        return type(e).__name__
    return None


def check(result_r, result_p):
    assert set(result_r) == set(result_p)
    for k in result_r:
        a, b = result_r[k], result_p[k]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            assert b == a, (k, b, a)


def scenario(fn):
    check(fn(R), fn(P))


# -- creation and dtypes ---------------------------------------------------------
def sc_creation(pk):
    t = pk.to_tensor
    return {
        "float_list": dname(pk, t([1.0, 2.0])),
        "int_list": dname(pk, t([1, 2])),
        "bool": dname(pk, t([True, False])),
        "np_f64": dname(pk, t(np.array([1.0, 2.0]))),
        "np_f64_scalar": dname(pk, t(np.float64(1.5))),
        "py_float": dname(pk, t(1.5)),
        "explicit": dname(pk, t([1, 2], dtype="float16")),
        "nested": dname(pk, t([[1, 2.5], [3, 4]])),
        "stop": t([1.0]).stop_gradient,
        "shape": t(np.zeros((2, 3, 4), np.float32)).shape,
        "ndim": t(np.zeros((2, 3), np.float32)).ndim,
        "size": t(np.zeros((2, 3), np.float32)).size,
        "scalar_shape": t(2.0).shape,
        "values": arr(t([[1, 2], [3, 4]], dtype="float32")),
        "item": t([[2.5]]).item(),
        "tolist": t([[1, 2], [3, 4]]).tolist(),
        "len": len(t(np.zeros((5, 2), np.float32))),
        "float": float(t(3.5)),
        "int": int(t(7)),
        "bool_of": bool(t(1.0)),
    }


def sc_promotion(pk):
    t = pk.to_tensor
    i64, i32 = t([1, 2]), t(np.array([1, 2], np.int32))
    f32 = t([1.0, 2.0])
    bf = t([1.0, 2.0], dtype="bfloat16")
    f16 = t([1.0, 2.0], dtype="float16")
    return {
        "i64/i64": dname(pk, i64 / i64),
        "i32/i32": dname(pk, i32 / i32),
        "i64*0.5": dname(pk, i64 * 0.5),
        "i64+f32": dname(pk, i64 + f32),
        "bf*f32": dname(pk, bf * f32),
        "bf*f16": dname(pk, bf * f16),
        "i32+i64": dname(pk, i32 + i64),
        "i32+2": dname(pk, i32 + 2),
        "f32+2": dname(pk, f32 + 2),
        "2-f32": dname(pk, 2 - f32),
        "bf*0.5": dname(pk, bf * 0.5),
        "sum_i32": dname(pk, pk.sum(i32)),
        "mean_i32": dname(pk, pk.mean(i32)),
        "mean_i64": dname(pk, pk.mean(i64)),
        "sqrt_i64": dname(pk, pk.sqrt(i64)),
        "sqrt_i32": dname(pk, pk.sqrt(i32)),
        "matmul_bf_f32": dname(pk, pk.matmul(
            t([[1.0]], dtype="bfloat16"), t([[2.0]]))),
        "cast": dname(pk, f32.astype("int32")),
        "i64//i64": dname(pk, i64 // i64),
        "i64**2": dname(pk, i64 ** 2),
        "cmp": dname(pk, i64 < f32),
        "i64/i64_values": arr(t([1, 3]) / t([2, 2])),
    }


DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "bfloat16",
          "float16", "float32", "float64", "complex64", "complex128"]


@pytest.mark.parametrize("a", DTYPES)
def test_promotion_lattice_row(a):
    """``dtypes.promote`` against ``jnp.promote_types`` (x64 on, as the
    reference runs) for every pair with ``a``."""
    for b in DTYPES:
        want = str(np.dtype(jnp.promote_types(jnp.dtype(a), jnp.dtype(b))))
        got = pdt.dtype_name(pdt.promote(pdt.convert_dtype(a),
                                         pdt.convert_dtype(b)))
        assert got == want, (a, b, got, want)


# -- stop_gradient and the op outputs ----------------------------------------------
def sc_stop_gradient(pk):
    a = pk.to_tensor([1.0, 2.0])
    b = pk.to_tensor([3.0, 4.0], stop_gradient=False)
    p = pk.nn.Linear(2, 2).weight
    i = pk.to_tensor([1, 2])
    i.stop_gradient = False
    out = {"a": a.stop_gradient, "b": b.stop_gradient,
           "param": p.stop_gradient, "a+a": (a + a).stop_gradient,
           "a+b": (a + b).stop_gradient, "b*2": (b * 2).stop_gradient,
           "int_leaf": i.stop_gradient, "int_op": (i + i).stop_gradient,
           "argmax": pk.argmax(b).stop_gradient,
           "cast_int": b.astype("int64").stop_gradient,
           "detach": b.detach().stop_gradient,
           "is_leaf_b": b.is_leaf, "is_leaf_op": (b * 2).is_leaf}
    with pk.no_grad():
        out["no_grad"] = (b * 2).stop_gradient
    with pk.no_grad():
        with pk.enable_grad():
            out["enable_in_no"] = (b * 2).stop_gradient
    with pk.set_grad_enabled(False):
        out["set_off"] = (b * 2).stop_gradient
        out["is_enabled"] = pk.is_grad_enabled()
    out["is_enabled_after"] = pk.is_grad_enabled()
    c = pk.to_tensor([1.0])
    c.stop_gradient = False
    out["flip"] = (c * 3).stop_gradient
    d = b * 2
    d.stop_gradient = True
    out["pruned"] = (d + b).stop_gradient
    (d * b).sum().backward()
    out["pruned_grad"] = arr(b.grad)
    return out


# -- backward and accumulation ---------------------------------------------------
def sc_backward(pk):
    x = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * x).sum().backward()
    g1 = arr(x.grad)
    (x * x).sum().backward()
    out = {"g1": g1, "g2": arr(x.grad)}
    x.clear_grad()
    out["cleared"] = x.grad is None
    (x * 3).sum().backward()
    x.clear_gradient(set_to_zero=True)
    out["zeroed"] = arr(x.grad)
    y = pk.to_tensor([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
    z = y * y
    z.backward(pk.to_tensor([[1.0, 0.0], [0.5, 2.0]]))
    out["seeded"] = arr(y.grad)
    w = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    loss = (w * w).sum()
    loss.backward(retain_graph=True)
    loss.backward()
    out["retained"] = arr(w.grad)
    v = pk.to_tensor([[1.0, 2.0]], stop_gradient=False)
    out["nonscalar"] = raises(lambda: (v * 2).backward())
    leaf = pk.to_tensor([2.0], stop_gradient=False)
    leaf.backward()
    out["leaf_seed"] = arr(leaf.grad)
    wide = pk.to_tensor([2.0, 3.0], stop_gradient=False)
    out["leaf_nonscalar"] = raises(lambda: wide.backward())
    u = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    pk.autograd.backward([(u * 2).sum(), (u * u).sum()])
    out["multi"] = arr(u.grad)
    s = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    out["non_leaf_grad"] = (s * 2).grad is None
    return out


def sc_grad(pk):
    x = pk.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    y = (x * x * x).sum()
    (dx,) = pk.grad([y], [x], create_graph=True)
    out = {"dx": arr(dx), "dx_stop": dx.stop_gradient,
           "x_grad_untouched": x.grad is None}
    (d2,) = pk.grad([dx.sum()], [x])
    out["d2"] = arr(d2)
    a = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    b = pk.to_tensor([3.0, 4.0], stop_gradient=False)
    ga, gb = pk.grad((a * b).sum(), [a, b])
    out.update(ga=arr(ga), gb=arr(gb))
    c = pk.to_tensor([1.0], stop_gradient=False)
    unused = pk.to_tensor([1.0], stop_gradient=False)
    out["unused_raises"] = raises(
        lambda: pk.grad((c * 2).sum(), [c, unused]))
    res = pk.grad((c * 2).sum(), [c, unused], allow_unused=True)
    out["unused_none"] = res[1] is None
    q = pk.to_tensor([0.5, 1.5], stop_gradient=False)
    (g,) = pk.grad([(pk.tanh(q) * q).sum()], [q], create_graph=True)
    (gg,) = pk.grad([(g * g).sum()], [q])
    out["tanh_gg"] = arr(gg)
    seed = pk.to_tensor([2.0, -1.0])
    (gs,) = pk.grad([q * 3], [q], grad_outputs=[seed])
    out["grad_outputs"] = arr(gs)
    return out


def sc_py_layer(pk):
    class Cube(pk.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor
            return g * 3 * x * x * ctx.k

    class Split(pk.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a + b, a * b

        @staticmethod
        def backward(ctx, g1, g2):
            return g1 + g2, g1 - g2

    x = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    y = Cube.apply(x, 2.0)
    y.sum().backward()
    out = {"y": arr(y), "y_stop": y.stop_gradient, "gx": arr(x.grad)}
    a = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    b = pk.to_tensor([3.0, 5.0], stop_gradient=False)
    s, p = Split.apply(a, b)
    (s.sum() * 2 + p.sum()).backward()
    out.update(s=arr(s), p=arr(p), ga=arr(a.grad), gb=arr(b.grad))
    z = pk.to_tensor([1.0, 2.0])
    out["no_grad_input"] = Cube.apply(z, 1.0).stop_gradient
    w = pk.to_tensor([1.5, 0.5], stop_gradient=False)
    (gw,) = pk.grad([Cube.apply(w, 1.0).sum()], [w], create_graph=True)
    (gww,) = pk.grad([gw.sum()], [w])
    out.update(gw=arr(gw), gww=arr(gww))
    return out


def sc_hooks(pk):
    x = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    seen = []
    x.register_hook(lambda g: seen.append(arr(g)) or g * 2)
    (x * 3).sum().backward()
    out = {"leaf": arr(x.grad), "seen": seen[0]}
    y = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    mid = y * y
    mid.register_hook(lambda g: g * 10)
    mid.sum().backward()
    out["non_leaf"] = arr(y.grad)
    return out


def sc_tensor_methods(pk):
    x = pk.to_tensor([[1.0, -2.0], [3.0, 4.0]], stop_gradient=False)
    c = x.clone()
    (c * c).sum().backward()
    out = {"clone_grad": arr(x.grad)}
    y = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    y.astype("float64").sum().backward()
    out["astype_grad"] = arr(y.grad)
    d = pk.to_tensor([1.0, 2.0], stop_gradient=False)
    d.set_value(np.array([5.0, 6.0], np.float32))
    out["set_value"] = arr(d)
    out["set_value_stop"] = d.stop_gradient
    out["set_value_shape"] = raises(
        lambda: d.set_value(np.zeros(3, np.float32)))
    (d * d).sum().backward()
    out["after_set"] = arr(d.grad)
    out["zero_"] = arr(pk.to_tensor([1.0, 2.0]).zero_())
    out["fill_"] = arr(pk.to_tensor([1.0, 2.0]).fill_(3.0))
    e = pk.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    out.update(T=arr(e.T), mT=arr(e.mT), neg=arr(-e), abs=arr(abs(-e)),
               matmul=arr(e @ e),
               pow=arr(e ** 2), rpow=arr(2 ** e), mod=arr(e % 3),
               floordiv=arr(e // 3), rtruediv=arr(1 / e),
               rsub=arr(1 - e), eq=arr(e == 2), ne=arr(e != 2),
               ge=arr(e >= 2), invert=arr(~(e > 2)), method_exp=arr(e.exp()),
               method_sum=arr(e.sum(axis=0)), method_reshape=e.reshape(
                   [4]).shape, numel=e.numel())
    f = pk.to_tensor([1.0, 2.0])
    f += 1
    f *= 3
    out["iadd"] = arr(f)
    g = pk.to_tensor([4.0, 9.0])
    g.sqrt_()
    out["sqrt_"] = arr(g)
    h = pk.to_tensor([1.0, -1.0], stop_gradient=False)
    k = h * 2
    k.exp_()
    k.sum().backward()
    out["inplace_grad"] = arr(h.grad)
    leaf = pk.to_tensor([0.5, 1.0], stop_gradient=False)
    leaf.exp_()
    (leaf * 2).sum().backward()
    out["inplace_leaf"] = arr(leaf)
    out["inplace_leaf_grad"] = arr(leaf.grad)
    return out


def sc_indexing(pk):
    x = pk.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                     stop_gradient=False)
    out = {"int": arr(x[1]), "slice": arr(x[:, 1:3, ::2]),
           "neg": arr(x[-1, -1]), "ellipsis": arr(x[..., 0]),
           "none": x[None].shape, "list": arr(x[:, [0, 2]]),
           "tensor": arr(x[pk.to_tensor([1, 0])]),
           "bool": arr(x[pk.to_tensor(np.array([True, False]))]),
           "scalar_tensor": arr(x[pk.to_tensor(1)])}
    x[0, 1:3].sum().backward()
    out["grad"] = arr(x.grad)
    y = pk.to_tensor(np.zeros((3, 4), np.float32))
    y[1] = 5.0
    y[:, 0] = pk.to_tensor([1.0, 2.0, 3.0])
    y[y > 4] = -1.0
    out["setitem"] = arr(y)
    z = pk.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    w = z * 1
    w[1] = 10.0
    (w * w).sum().backward()
    out["setitem_grad"] = arr(z.grad)
    return out


@pytest.mark.parametrize("fn", [sc_creation, sc_promotion, sc_stop_gradient,
                                sc_backward, sc_grad, sc_py_layer, sc_hooks,
                                sc_tensor_methods, sc_indexing],
                         ids=lambda f: f.__name__[3:])
def test_scenario_matches_reference(fn):
    scenario(fn)


def test_tensor_holds_one_torch_tensor_and_autograd_is_torch():
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    assert isinstance(x._value, torch.Tensor) and x._value.requires_grad
    y = x * x
    assert y._value.grad_fn is not None
    p = P.nn.Linear(2, 3).weight
    assert isinstance(p._value, torch.nn.Parameter)
    assert P.core.device.get_device() == "cpu"
    assert x.place == P.CPUPlace()
    assert P.CUDAPlace is P.TPUPlace


def test_save_load_round_trip_and_reference_interop(tmp_path):
    sd = {"w": P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3)),
          "b": P.to_tensor([1.0, 2.0], dtype="bfloat16"),
          "n": P.to_tensor([1, 2]), "meta": {"step": 3}}
    path = str(tmp_path / "m.pdparams")
    P.save(sd, path)
    back = P.load(path)
    assert back["meta"] == {"step": 3}
    for k in ("w", "b", "n"):
        assert back[k].dtype == sd[k].dtype
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy())
    ref = R.load(path)
    np.testing.assert_array_equal(np.asarray(ref["w"].numpy()),
                                  sd["w"].numpy())
    assert str(np.dtype(ref["b"].dtype)) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(ref["b"].numpy(), np.float32),
                                  sd["b"].numpy())
    rpath = str(tmp_path / "r.pdparams")
    R.save({"x": R.to_tensor(np.ones((2, 2), np.float32) * 3)}, rpath)
    np.testing.assert_array_equal(P.load(rpath)["x"].numpy(),
                                  np.full((2, 2), 3, np.float32))


# the reference's top-level names (paddle_tpu/__init__.py's imports from
# core, ops.random and autograd, and its aliases)
TOP_LEVEL = ("bfloat16", "float16", "float32", "float64", "int8", "int16",
             "int32", "int64", "uint8", "bool_", "complex64", "complex128",
             "get_default_dtype", "set_default_dtype", "Tensor", "to_tensor",
             "set_printoptions", "get_flags", "set_flags", "CPUPlace",
             "TPUPlace", "CustomPlace", "set_device", "get_device",
             "device_count", "is_compiled_with_tpu", "seed",
             "get_rng_state", "set_rng_state", "default_generator",
             "Generator", "autograd", "no_grad", "enable_grad", "grad",
             "set_grad_enabled", "is_grad_enabled", "bool", "CUDAPlace",
             "CUDAPinnedPlace", "get_cuda_rng_state", "set_cuda_rng_state",
             "shape", "tolist", "check_shape", "is_grad_enabled_",
             "disable_signal_handler", "LazyGuard", "nn", "amp",
             "optimizer", "save", "load")


def test_top_level_names_exist():
    assert all(hasattr(R, n) for n in TOP_LEVEL)
    missing = [n for n in TOP_LEVEL if not hasattr(P, n)]
    assert not missing, missing
    assert P.bool is P.bool_ and P.CUDAPlace is P.TPUPlace
    np.testing.assert_array_equal(
        P.shape(P.zeros([2, 3])).numpy(), R.shape(R.zeros([2, 3])).numpy())


def test_default_dtype_and_flags_restore():
    def probe(pk):
        old = pk.get_default_dtype()
        pk.set_default_dtype("float64")
        try:
            made = dname(pk, pk.to_tensor([1.5]))
            eye = dname(pk, pk.eye(2))
        finally:
            pk.set_default_dtype(old)
        pk.set_flags({"check_nan_inf": True})
        try:
            err = raises(lambda: pk.log(pk.to_tensor([-1.0])))
        finally:
            pk.set_flags({"check_nan_inf": False})
        return {"made": made, "eye": eye, "err": err,
                "flag": pk.get_flags(["FLAGS_check_nan_inf"])[
                    "FLAGS_check_nan_inf"]}
    check(probe(R), probe(P))
    assert P.get_default_dtype() == P.float32
