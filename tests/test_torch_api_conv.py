"""Convolution and pooling of the paddle API, port against reference on
the CPU: ``nn.functional``'s ``conv`` and ``pooling`` families on the
same seeded inputs (paddle's padding forms, channel-last layouts, groups
with dilation, transposes with ``output_padding`` and ``output_size``,
``ceil_mode`` windows that start in the padding, ``exclusive``, masks
and unpooling, adaptive and fractional pools), and their layers on
carried weights.  Forward and every input's gradient within 1e-5 of the
largest magnitude, masks exact, dtypes the reference's."""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)
from torch_api_parity import (carried, compare_scaled, run_both,
                              run_cases, run_layers, seed_of)

TOL = 1e-5
NF = "nn.functional."


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def F(*shape):
    return lambda r: r.randn(*shape).astype(np.float32)


CONV = [
    ("conv2d_groups", "conv2d", [F(2, 4, 7, 7), F(6, 2, 3, 3), F(6)],
     dict(stride=2, padding=1, groups=2)),
    ("conv2d_same_stride", "conv2d", [F(2, 4, 7, 7), F(6, 4, 3, 3)],
     dict(padding="SAME", stride=2)),
    ("conv2d_valid_dilated_groups", "conv2d", [F(2, 4, 9, 9), F(4, 2, 3, 3)],
     dict(padding="VALID", dilation=2, groups=2)),
    ("conv2d_nhwc_per_side", "conv2d", [F(2, 7, 7, 4), F(6, 4, 3, 2)],
     dict(padding=[1, 0, 2, 1], data_format="NHWC")),
    ("conv1d_full_form", "conv1d", [F(1, 3, 6), F(2, 3, 3)],
     dict(padding=[[0, 0], [0, 0], [1, 2]])),
    ("conv1d", "conv1d", [F(2, 3, 10), F(4, 3, 3), F(4)],
     dict(padding=2, stride=3)),
    ("conv1d_nlc", "conv1d", [F(2, 10, 3), F(4, 3, 3)],
     dict(padding="SAME", data_format="NLC")),
    ("conv3d", "conv3d", [F(1, 2, 5, 5, 5), F(3, 2, 3, 3, 3)],
     dict(padding=1, stride=(1, 2, 1))),
    ("conv2d_transpose", "conv2d_transpose",
     [F(2, 4, 5, 5), F(4, 3, 3, 3), F(3)],
     dict(stride=2, padding=1, output_padding=1)),
    ("conv2d_transpose_groups_dil", "conv2d_transpose",
     [F(2, 4, 5, 5), F(4, 2, 3, 3)], dict(stride=2, padding=1, groups=2,
                                          dilation=2)),
    ("conv2d_transpose_output_size", "conv2d_transpose",
     [F(2, 4, 5, 5), F(4, 3, 3, 3)],
     dict(stride=2, padding=1, output_size=[10, 10])),
    ("conv2d_transpose_nhwc", "conv2d_transpose",
     [F(2, 5, 5, 4), F(4, 3, 3, 3)],
     dict(stride=2, padding=1, data_format="NHWC")),
    ("conv1d_transpose", "conv1d_transpose", [F(2, 4, 6), F(4, 3, 3)],
     dict(stride=3, padding=1)),
    ("conv3d_transpose", "conv3d_transpose",
     [F(1, 2, 3, 3, 3), F(2, 2, 2, 2, 2), F(2)], dict(stride=2)),
]

POOL = [
    ("max_pool2d", "max_pool2d", [F(2, 3, 9, 9)],
     dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d_ceil", "max_pool2d", [F(2, 3, 8, 8)],
     dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ("max_pool2d_same", "max_pool2d", [F(2, 3, 8, 8)],
     dict(kernel_size=2, stride=2, padding="SAME")),
    ("max_pool2d_nhwc_wide_pad", "max_pool2d", [F(2, 8, 8, 3)],
     dict(kernel_size=3, stride=2, padding=[0, 2, 1, 0],
          data_format="NHWC")),
    ("max_pool2d_mask", "max_pool2d", [F(2, 3, 8, 8)],
     dict(kernel_size=3, stride=2, padding=1, return_mask=True)),
    ("max_pool2d_mask_ceil", "max_pool2d", [F(2, 3, 8, 8)],
     dict(kernel_size=3, stride=2, padding=1, return_mask=True,
          ceil_mode=True)),
    ("max_pool1d_mask", "max_pool1d", [F(2, 3, 9)],
     dict(kernel_size=3, stride=2, padding=1, return_mask=True)),
    ("max_pool3d_mask", "max_pool3d", [F(1, 2, 5, 5, 5)],
     dict(kernel_size=2, stride=2, return_mask=True)),
    ("max_pool3d", "max_pool3d", [F(1, 2, 5, 6, 5)],
     dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ("avg_pool2d_exclusive", "avg_pool2d", [F(2, 3, 9, 9)],
     dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d_inclusive", "avg_pool2d", [F(2, 3, 9, 9)],
     dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
    ("avg_pool2d_ceil", "avg_pool2d", [F(2, 3, 8, 8)],
     dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ("avg_pool1d", "avg_pool1d", [F(2, 3, 9)],
     dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool3d_same", "avg_pool3d", [F(1, 2, 5, 5, 5)],
     dict(kernel_size=2, stride=2, padding="SAME")),
    ("adaptive_avg_pool2d", "adaptive_avg_pool2d", [F(2, 3, 7, 9)],
     dict(output_size=[3, 4])),
    ("adaptive_avg_pool2d_none", "adaptive_avg_pool2d", [F(2, 3, 7, 9)],
     dict(output_size=[None, 4])),
    ("adaptive_avg_pool2d_nhwc", "adaptive_avg_pool2d", [F(2, 7, 9, 3)],
     dict(output_size=1, data_format="NHWC")),
    ("adaptive_avg_pool1d", "adaptive_avg_pool1d", [F(2, 3, 7)],
     dict(output_size=3)),
    ("adaptive_avg_pool3d", "adaptive_avg_pool3d", [F(1, 2, 5, 6, 7)],
     dict(output_size=[2, 3, 4])),
    ("adaptive_max_pool2d", "adaptive_max_pool2d", [F(2, 3, 7, 9)],
     dict(output_size=[3, 4])),
    ("adaptive_max_pool1d", "adaptive_max_pool1d", [F(2, 3, 7)],
     dict(output_size=3)),
    ("adaptive_max_pool3d", "adaptive_max_pool3d", [F(1, 2, 5, 6, 7)],
     dict(output_size=2)),
    ("fractional_max_pool2d_mask", "fractional_max_pool2d", [F(2, 3, 9, 9)],
     dict(output_size=4, random_u=0.3, return_mask=True)),
    ("fractional_max_pool2d_kernel", "fractional_max_pool2d",
     [F(2, 3, 9, 9)], dict(output_size=4, kernel_size=2, random_u=0.6)),
]


def _check(case):
    cid, name, makers, kwargs = case
    ref, port = run_both(NF + name, makers, kwargs, seed=seed_of(cid))
    compare_scaled(ref, port, TOL)


def _groups(cases, n):
    return [cases[i:i + n] for i in range(0, len(cases), n)]


GROUPS = _groups(CONV, 5) + _groups(POOL, 6)


@pytest.mark.parametrize("group", GROUPS,
                         ids=["%s-%s" % (g[0][0], g[-1][0]) for g in GROUPS])
def test_functionals_match_reference(group):
    run_cases(group, _check)


def _unpool_case(nd, shape, k, s, p):
    """A pooled input and its mask through the reference's max pool, then
    the unpool on both packages (the values' gradient included)."""
    rng = np.random.RandomState(seed_of("unpool%d" % nd))
    x = rng.randn(*shape).astype(np.float32)
    pool = getattr(R.nn.functional, "max_pool%dd" % nd)
    out, mask = pool(R.to_tensor(x), k, s, p, return_mask=True)
    vals, idx = np.asarray(out.numpy()), np.asarray(mask.numpy())
    return ("max_unpool%dd" % nd, [lambda r: vals, lambda r: idx],
            dict(kernel_size=k, stride=s, padding=p,
                 output_size=list(shape)))


@pytest.mark.parametrize("nd,shape", [(1, (2, 3, 9)), (2, (2, 3, 9, 9)),
                                      (3, (1, 2, 6, 6, 6))])
def test_max_unpool_matches_reference(nd, shape):
    name, makers, kw = _unpool_case(nd, shape, 3 if nd < 3 else 2, 2,
                                    1 if nd < 3 else 0)
    ref, port = run_both(NF + name, makers, kw, seed=seed_of(name))
    compare_scaled(ref, port, TOL)


def test_pool_mask_round_trips_through_unpool():
    """Each window's maximum lands back at its mask's position."""
    x = P.to_tensor(np.random.RandomState(0).randn(2, 3, 8, 8).astype(
        np.float32))
    out, mask = P.nn.functional.max_pool2d(x, 2, 2, return_mask=True)
    back = P.nn.functional.max_unpool2d(out, mask, 2, 2).numpy()
    flat = back.reshape(2, 3, -1)
    picked = np.take_along_axis(flat, mask.numpy().reshape(2, 3, -1)
                                .astype(np.int64), -1)
    np.testing.assert_array_equal(picked, out.numpy().reshape(2, 3, -1))
    assert (back != 0).sum() == out.numpy().size
    assert str(mask.numpy().dtype) == "int32"


LAYERS = [
    ("Conv1D", dict(in_channels=3, out_channels=4, kernel_size=3,
                    padding=1), [F(2, 3, 8)]),
    ("Conv2D", dict(in_channels=4, out_channels=6, kernel_size=3, stride=2,
                    padding=1, groups=2), [F(2, 4, 7, 7)]),
    ("Conv3D", dict(in_channels=2, out_channels=3, kernel_size=2,
                    bias_attr=False), [F(1, 2, 4, 4, 4)]),
    ("Conv1DTranspose", dict(in_channels=3, out_channels=2, kernel_size=3,
                             stride=2), [F(2, 3, 5)]),
    ("Conv2DTranspose", dict(in_channels=4, out_channels=6, kernel_size=3,
                             stride=2, padding=1, output_padding=1,
                             groups=2), [F(2, 4, 5, 5)]),
    ("Conv3DTranspose", dict(in_channels=2, out_channels=2, kernel_size=2,
                             stride=2), [F(1, 2, 3, 3, 3)]),
    ("MaxPool1D", dict(kernel_size=3, stride=2, padding=1), [F(2, 3, 9)]),
    ("MaxPool2D", dict(kernel_size=3, stride=2, padding=1), [F(2, 3, 9, 9)]),
    ("MaxPool3D", dict(kernel_size=2), [F(1, 2, 4, 4, 4)]),
    ("AvgPool1D", dict(kernel_size=2), [F(2, 3, 8)]),
    ("AvgPool2D", dict(kernel_size=3, stride=2, padding=1,
                       exclusive=False), [F(2, 3, 9, 9)]),
    ("AvgPool3D", dict(kernel_size=2, ceil_mode=True), [F(1, 2, 5, 5, 5)]),
    ("AdaptiveAvgPool1D", dict(output_size=3), [F(2, 3, 7)]),
    ("AdaptiveAvgPool2D", dict(output_size=1), [F(2, 3, 7, 7)]),
    ("AdaptiveAvgPool3D", dict(output_size=2), [F(1, 2, 5, 5, 5)]),
    ("AdaptiveMaxPool1D", dict(output_size=3), [F(2, 3, 7)]),
    ("AdaptiveMaxPool2D", dict(output_size=[2, 3]), [F(2, 3, 7, 7)]),
    ("AdaptiveMaxPool3D", dict(output_size=2), [F(1, 2, 5, 5, 5)]),
    ("FractionalMaxPool2D", dict(output_size=3, random_u=0.4),
     [F(2, 3, 8, 8)]),
    ("FractionalMaxPool3D", dict(output_size=2, random_u=0.4),
     [F(1, 2, 5, 5, 5)]),
]


def _check_layer(case):
    name, kwargs, makers = case
    R.seed(seed_of(name))
    ref_layer = getattr(R.nn, name)(**kwargs)
    port_layer = carried(ref_layer, getattr(P.nn, name)(**kwargs))
    ref, port = run_layers(ref_layer, port_layer, makers, seed_of(name))
    compare_scaled(ref, port, TOL)


LAYER_GROUPS = _groups(LAYERS, 7)


@pytest.mark.parametrize("group", LAYER_GROUPS,
                         ids=["%s-%s" % (g[0][0], g[-1][0])
                              for g in LAYER_GROUPS])
def test_layers_on_carried_weights_match_reference(group):
    run_cases([(c[0],) + c[1:] for c in group], _check_layer)


def test_conv_layer_weights_keep_paddle_layouts():
    conv = P.nn.Conv2D(4, 6, (3, 2), groups=2)
    convt = P.nn.Conv2DTranspose(4, 6, 3, groups=2)
    assert conv.weight.shape == [6, 2, 3, 2] and conv.bias.shape == [6]
    assert convt.weight.shape == [4, 3, 3, 3]
    ref = R.nn.Conv2D(4, 6, (3, 2), groups=2)
    assert sorted(ref.state_dict()) == sorted(conv.state_dict())


def test_refused_paddings_raise_as_the_reference():
    """A transpose's string padding, and a 2-D full-form padding list
    (its length is the per-side form's), raise ``ValueError`` in both."""
    x = np.zeros((1, 2, 4, 4), np.float32)
    w = np.zeros((2, 2, 3, 3), np.float32)
    for pkg in (R, P):
        f = pkg.nn.functional
        with pytest.raises(ValueError):
            f.conv2d_transpose(pkg.to_tensor(x), pkg.to_tensor(w), stride=2,
                               padding="SAME").numpy()
        with pytest.raises(ValueError):
            f.conv2d(pkg.to_tensor(x), pkg.to_tensor(w),
                     padding=[[0, 0], [0, 0], [1, 1], [1, 1]]).numpy()


def test_fractional_pool_draws_from_the_framework_generator():
    x = P.to_tensor(np.random.RandomState(1).randn(1, 1, 9, 9).astype(
        np.float32))
    P.seed(3)
    a = P.nn.functional.fractional_max_pool2d(x, 4).numpy()
    b = P.nn.functional.fractional_max_pool2d(x, 4).numpy()
    P.seed(3)
    c = P.nn.functional.fractional_max_pool2d(x, 4).numpy()
    np.testing.assert_array_equal(a, c)
    assert a.shape == b.shape == (1, 1, 4, 4)


def test_every_conv_and_pool_functional_is_tested():
    import inspect
    from paddle_tpu.nn.functional import conv as rc, pooling as rp
    names = {n for m in (rc, rp) for n, o in vars(m).items()
             if inspect.isfunction(o) and o.__module__ == m.__name__
             and not n.startswith("_")}
    tested = {c[1] for c in CONV + POOL} | {
        "max_unpool1d", "max_unpool2d", "max_unpool3d"}
    assert names - tested == set(), sorted(names - tested)
    assert all(hasattr(P.nn.functional, n) for n in names)
    layer_names = {c[0] for c in LAYERS}
    assert {"Conv2D", "MaxPool2D", "AdaptiveAvgPool2D"} <= layer_names
