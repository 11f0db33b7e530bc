"""The vision ops, the extended functionals, bicubic ``interpolate``, the
rest of ``nn``'s layers and ``nn.utils``, port against reference on the
CPU: the same seeded inputs through ``paddle_tpu`` and
``paddle_tpu_torch`` (``affine_grid``/``grid_sample`` by the reference's
own reflection and unnormalisation, ``channel_shuffle``,
``temporal_shift``, ``pairwise_distance``, the triplet, hierarchical
sigmoid and RNN-T losses, ``fractional_max_pool3d``; bicubic resizes up,
down and corner-aligned), layers on carried weights, and ``weight_norm``
and ``spectral_norm`` under the reference's parameter names.  Forward
and every input's gradient within 1e-5 of the largest magnitude."""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu.nn.utils as RU
import paddle_tpu_torch as P
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)
from torch_api_parity import (carried, compare_scaled, run_both, run_cases,
                              run_layers, seed_of)

TOL = 1e-5
NF = "nn.functional."


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def F(*shape, lo=None, hi=None):
    if lo is not None:
        return lambda r: r.uniform(lo, hi, shape).astype(np.float32)
    return lambda r: r.randn(*shape).astype(np.float32)


def C(v):
    return lambda r: v


def I(*values):
    return lambda r: np.array(values, np.int64)


GRID = F(2, 4, 3, 2, lo=-1.2, hi=1.2)

FUNCTIONALS = [
    ("affine_grid_2d", "affine_grid", [F(2, 2, 3)],
     dict(out_shape=[2, 3, 4, 5], align_corners=False)),
    ("affine_grid_3d", "affine_grid", [F(2, 3, 4)],
     dict(out_shape=[2, 3, 3, 4, 5])),
    ("grid_sample_bilinear_zeros", "grid_sample", [F(2, 3, 5, 6), GRID], {}),
    ("grid_sample_reflection", "grid_sample", [F(2, 3, 5, 6), GRID],
     dict(padding_mode="reflection", align_corners=False)),
    ("grid_sample_reflection_aligned", "grid_sample", [F(2, 3, 5, 6), GRID],
     dict(padding_mode="reflection")),
    ("grid_sample_nearest_border", "grid_sample", [F(2, 3, 5, 6), GRID],
     dict(padding_mode="border", mode="nearest")),
    ("grid_sample_3d", "grid_sample",
     [F(1, 2, 4, 5, 6), F(1, 3, 2, 4, 3, lo=-1.2, hi=1.2)], {}),
    ("channel_shuffle", "channel_shuffle", [F(2, 6, 3, 3)], dict(groups=3)),
    ("channel_shuffle_nhwc", "channel_shuffle", [F(2, 3, 3, 6)],
     dict(groups=2, data_format="NHWC")),
    ("temporal_shift", "temporal_shift", [F(4, 8, 3, 3)], dict(seg_num=2)),
    ("temporal_shift_nhwc", "temporal_shift", [F(4, 3, 3, 8)],
     dict(seg_num=2, shift_ratio=0.125, data_format="NHWC")),
    ("pairwise_distance", "pairwise_distance", [F(4, 5), F(4, 5)], {}),
    ("pairwise_distance_inf", "pairwise_distance", [F(4, 5), F(4, 5)],
     dict(p=float("inf"), keepdim=True)),
    ("pairwise_distance_p1", "pairwise_distance", [F(4, 5), F(4, 5)],
     dict(p=1.0)),
    ("triplet_with_distance_swap", "triplet_margin_with_distance_loss",
     [F(4, 5), F(4, 5), F(4, 5)], dict(swap=True)),
    ("triplet_with_distance_sum", "triplet_margin_with_distance_loss",
     [F(4, 5), F(4, 5), F(4, 5)], dict(margin=0.5, reduction="sum")),
    ("hsigmoid_loss", "hsigmoid_loss",
     [F(4, 6), I(0, 3, 6, 2), C(7), F(6, 6), F(6)], {}),
    ("hsigmoid_loss_custom_path", "hsigmoid_loss",
     [F(3, 4), I(0, 1, 2), C(4), F(3, 4)],
     dict(path_table=np.array([[0, 1, -1], [0, 2, -1], [0, -1, -1]],
                              np.int64),
          path_code=np.array([[0, 1, 0], [1, 0, 0], [1, 0, 0]],
                             np.int64))),
    ("rnnt_loss", "rnnt_loss",
     [F(2, 4, 3, 5), lambda r: np.array([[1, 2], [3, 1]], np.int64),
      I(4, 3), I(2, 1)], {}),
    ("rnnt_loss_sum_blank", "rnnt_loss",
     [F(2, 3, 3, 4), lambda r: np.array([[1, 2], [2, 2]], np.int64),
      I(3, 3), I(2, 2)], dict(blank=3, reduction="sum")),
    ("fractional_max_pool3d", "fractional_max_pool3d", [F(1, 2, 7, 7, 7)],
     dict(output_size=3, random_u=0.3, return_mask=True)),
    ("fractional_max_pool3d_default_u", "fractional_max_pool3d",
     [F(1, 2, 6, 7, 5)], dict(output_size=[2, 3, 2])),
    ("bicubic_up", "interpolate", [F(2, 3, 5, 6)],
     dict(size=[9, 11], mode="bicubic")),
    ("bicubic_down_antialiased", "interpolate", [F(2, 3, 9, 10)],
     dict(size=[4, 6], mode="bicubic")),
    ("bicubic_one_dim", "interpolate", [F(1, 2, 6, 6)],
     dict(size=[6, 13], mode="bicubic")),
    ("bicubic_align_corners", "interpolate", [F(2, 3, 5, 6)],
     dict(size=[9, 4], mode="bicubic", align_corners=True)),
    ("bicubic_nhwc_scale", "interpolate", [F(2, 5, 6, 3)],
     dict(scale_factor=2, mode="bicubic", data_format="NHWC")),
]


def _check(case):
    cid, name, makers, kwargs = case
    ref, port = run_both(NF + name, makers, kwargs, seed=seed_of(cid))
    compare_scaled(ref, port, TOL)


GROUPS = [FUNCTIONALS[i:i + 7] for i in range(0, len(FUNCTIONALS), 7)]


@pytest.fixture(scope="module", autouse=True)
def reference_tree_cache():
    """The reference caches its default hierarchical-sigmoid tree as
    arrays; made outside a trace first, so its traced runs reuse
    constants."""
    from paddle_tpu.nn.functional import extended
    for c in (4, 6, 7):
        extended._hsigmoid_tree(c)


@pytest.mark.parametrize("group", GROUPS,
                         ids=["%s-%s" % (g[0][0], g[-1][0]) for g in GROUPS])
def test_functionals_match_reference(group):
    run_cases(group, _check)


def test_bicubic_is_keys_a_half_not_torchs():
    """The reference's cubic kernel (a = -0.5) differs from torch's
    bicubic (a = -0.75): the port follows the reference."""
    import torch
    x = np.random.RandomState(3).randn(1, 1, 4, 5).astype(np.float32)
    got = P.nn.functional.interpolate(P.to_tensor(x), size=[8, 10],
                                      mode="bicubic").numpy()
    want = np.asarray(R.nn.functional.interpolate(
        R.to_tensor(x), size=[8, 10], mode="bicubic").numpy())
    torch_cubic = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(8, 10), mode="bicubic").numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(torch_cubic - want).max() > 1e-3


LAYERS = [
    ("ChannelShuffle", dict(groups=2), [F(2, 4, 3, 3)]),
    ("PairwiseDistance", dict(p=3.0), [F(3, 4), F(3, 4)]),
    ("TripletMarginWithDistanceLoss", dict(margin=0.3),
     [F(4, 5), F(4, 5), F(4, 5)]),
    ("HSigmoidLoss", dict(feature_size=5, num_classes=6),
     [F(4, 5), I(0, 5, 3, 1)]),
    ("RNNTLoss", dict(reduction="none"),
     [F(2, 4, 3, 5), lambda r: np.array([[1, 2], [3, 1]], np.int64),
      I(4, 3), I(2, 1)]),
    ("AdaptiveLogSoftmaxWithLoss",
     dict(in_features=8, n_classes=12, cutoffs=[4, 8]),
     [F(5, 8), I(0, 5, 9, 11, 3)]),
]


def _check_layer(case):
    name, kwargs, makers = case
    R.seed(seed_of(name))
    ref_layer = getattr(R.nn, name)(**kwargs)
    port_layer = carried(ref_layer, getattr(P.nn, name)(**kwargs))
    ref, port = run_layers(ref_layer, port_layer, makers, seed_of(name))
    compare_scaled(ref, port, TOL)


def test_layers_on_carried_weights_match_reference():
    run_cases(LAYERS, _check_layer)


def test_adaptive_log_softmax_log_prob_and_predict():
    R.seed(5)
    ref = R.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 8], head_bias=True)
    port = carried(ref, P.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 8],
                                                        head_bias=True))
    x = np.random.RandomState(5).randn(6, 8).astype(np.float32)
    want = np.asarray(ref.log_prob(R.to_tensor(x)).numpy())
    got = port.log_prob(P.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(port.predict(P.to_tensor(x)).numpy(),
                                  np.asarray(ref.predict(
                                      R.to_tensor(x)).numpy()))


def test_spectral_norm_layer_draws_and_updates_as_the_reference():
    """``SpectralNorm``'s ``weight_u``/``weight_v`` are numpy
    ``RandomState(0)`` draws in both packages (equal bit for bit); two
    forwards normalise the weight and advance the buffers alike."""
    ref = R.nn.SpectralNorm([4, 3, 2], dim=1, power_iters=2)
    port = P.nn.SpectralNorm([4, 3, 2], dim=1, power_iters=2)
    for k in ("weight_u", "weight_v"):
        np.testing.assert_array_equal(port.state_dict()[k].numpy(),
                                      np.asarray(ref.state_dict()[k]
                                                 .numpy()))
    w = np.random.RandomState(2).randn(4, 3, 2).astype(np.float32)
    for _ in range(2):
        want = np.asarray(ref(R.to_tensor(w)).numpy())
        got = port(P.to_tensor(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for k in ("weight_u", "weight_v"):
        np.testing.assert_allclose(port.state_dict()[k].numpy(),
                                   np.asarray(ref.state_dict()[k].numpy()),
                                   rtol=TOL, atol=TOL)


def test_feature_alpha_dropout_drops_whole_channels_by_the_seed():
    x = P.to_tensor(np.ones((8, 16, 3, 3), np.float32))
    layer = P.nn.FeatureAlphaDropout(0.5)
    P.seed(4)
    a = layer(x).numpy()
    P.seed(4)
    b = layer(x).numpy()
    np.testing.assert_array_equal(a, b)
    per_channel = a.reshape(8, 16, 9)
    assert (per_channel == per_channel[..., :1]).all()   # whole channels
    assert len(np.unique(per_channel[..., 0])) == 2       # kept, dropped
    layer.eval()
    np.testing.assert_array_equal(layer(x).numpy(), x.numpy())


def _linear_pair(seed, in_f=5, out_f=4):
    R.seed(seed)
    ref = R.nn.Linear(in_f, out_f)
    return ref, carried(ref, P.nn.Linear(in_f, out_f))


def _forward_grads(layer, pkg, x, names):
    out = layer(pkg.to_tensor(x))
    (out * out).sum().backward()
    params = dict(layer.named_parameters())
    return (np.asarray(out.numpy()),
            [np.asarray(params[n].grad.numpy()) for n in names])


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_reference(dim):
    ref, port = _linear_pair(seed_of("wn%s" % dim))
    RU.weight_norm(ref, dim=dim)
    P.nn.utils.weight_norm(port, dim=dim)
    assert sorted(ref.state_dict()) == sorted(port.state_dict())
    assert "weight_g" in port.state_dict() and "weight_v" in \
        port.state_dict()
    x = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    names = ["weight_g", "weight_v", "bias"]
    r_out, r_g = _forward_grads(ref, R, x, names)
    p_out, p_g = _forward_grads(port, P, x, names)
    np.testing.assert_allclose(p_out, r_out, rtol=TOL, atol=TOL)
    for a, b in zip(p_g, r_g):
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
    RU.remove_weight_norm(ref)
    P.nn.utils.remove_weight_norm(port)
    assert sorted(ref.state_dict()) == sorted(port.state_dict()) == \
        ["bias", "weight"]
    np.testing.assert_allclose(port.weight.numpy(),
                               np.asarray(ref.weight.numpy()), rtol=TOL,
                               atol=TOL)


def test_spectral_norm_matches_reference():
    """``spectral_norm`` over a Linear (dim 1): the same ``weight_orig``
    parameter, output and gradients; the power iteration's start vector
    is the reference's (a JAX draw the port cannot make: carried
    across)."""
    import torch
    R.seed(7)
    ref = R.nn.Linear(5, 4)
    port = carried(ref, P.nn.Linear(5, 4))
    RU.spectral_norm(ref, n_power_iterations=3)
    P.nn.utils.spectral_norm(port, n_power_iterations=3)
    assert sorted(ref.state_dict()) == sorted(port.state_dict()) == \
        ["bias", "weight_orig"]
    (r_hook,) = ref._forward_pre_hooks.values()
    (p_hook,) = port._forward_pre_hooks.values()
    p_hook._u = torch.from_numpy(np.asarray(r_hook._u))
    x = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    names = ["weight_orig", "bias"]
    r_out, r_g = _forward_grads(ref, R, x, names)
    p_out, p_g = _forward_grads(port, P, x, names)
    np.testing.assert_allclose(p_out, r_out, rtol=TOL, atol=TOL)
    for a, b in zip(p_g, r_g):
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()


def test_spectral_norm_of_a_conv_runs_in_the_weights_dtype():
    """The reference's start vector is float64 (its x64 default), which
    turns a Conv2D's normalised weight float64 and its convolution
    refuses the mixed dtypes; the port keeps the weight's dtype and
    divides by the power iteration's sigma (checked in numpy)."""
    R.seed(8)
    ref = R.nn.Conv2D(2, 3, 3)
    port = carried(ref, P.nn.Conv2D(2, 3, 3))
    RU.spectral_norm(ref, n_power_iterations=2)
    P.nn.utils.spectral_norm(port, n_power_iterations=2)
    x = np.random.RandomState(3).randn(1, 2, 5, 5).astype(np.float32)
    with pytest.raises(TypeError):
        ref(R.to_tensor(x))
    out = port(P.to_tensor(x))
    assert str(out.numpy().dtype) == "float32"
    (hook,) = port._forward_pre_hooks.values()
    w = port.weight_orig.numpy().astype(np.float64)
    wm, u = w.reshape(3, -1), hook._u.numpy().astype(np.float64)
    for _ in range(2):
        v = wm.T @ u
        v /= np.linalg.norm(v) + 1e-12
        u = wm @ v
        u /= np.linalg.norm(u) + 1e-12
    np.testing.assert_allclose(port.weight.numpy(), w / (u @ wm @ v),
                               rtol=1e-5, atol=1e-6)


def test_vector_packing_and_gradient_clips_match_reference():
    ref, port = _linear_pair(11, 6, 3)
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    for layer, pkg in ((ref, R), (port, P)):
        (layer(pkg.to_tensor(x)) ** 2).sum().backward()
    r_vec = RU.parameters_to_vector(ref.parameters())
    p_vec = P.nn.utils.parameters_to_vector(port.parameters())
    np.testing.assert_array_equal(p_vec.numpy(), np.asarray(r_vec.numpy()))
    r_norm = RU.clip_grad_norm_(ref.parameters(), 0.5)
    p_norm = P.nn.utils.clip_grad_norm_(port.parameters(), 0.5)
    np.testing.assert_allclose(float(p_norm), float(r_norm), rtol=TOL)
    RU.clip_grad_value_(ref.parameters(), 0.01)
    P.nn.utils.clip_grad_value_(port.parameters(), 0.01)
    for a, b in zip(port.parameters(), ref.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(
            b.grad.numpy()), rtol=TOL, atol=1e-7)
    new = np.arange(p_vec.numpy().size, dtype=np.float32)
    P.nn.utils.vector_to_parameters(P.to_tensor(new), port.parameters())
    RU.vector_to_parameters(R.to_tensor(new), ref.parameters())
    for a, b in zip(port.parameters(), ref.parameters()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))


def test_class_center_sample_keeps_the_labels_and_the_seed():
    label = P.to_tensor(np.array([3, 7, 3, 1], np.int64))
    P.seed(9)
    remap, sampled = P.nn.functional.class_center_sample(label, 20, 6)
    P.seed(9)
    remap2, sampled2 = P.nn.functional.class_center_sample(label, 20, 6)
    s = sampled.numpy()
    np.testing.assert_array_equal(s, sampled2.numpy())
    assert len(s) == 6 and {1, 3, 7} <= set(s.tolist())
    assert list(s) == sorted(s)
    np.testing.assert_array_equal(s[remap.numpy()], [3, 7, 3, 1])
    want_r, want_s = R.nn.functional.class_center_sample(
        R.to_tensor(np.array([3, 7, 3, 1], np.int64)), 20, 3)
    got_r, got_s = P.nn.functional.class_center_sample(label, 20, 3)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s.numpy()))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r.numpy()))


def test_every_vision_extended_and_layer_name_is_ported_and_tested():
    import inspect
    from paddle_tpu.nn.functional import vision as rv, extended as rx
    names = {n for m in (rv, rx) for n, o in vars(m).items()
             if inspect.isfunction(o) and o.__module__ == m.__name__
             and not n.startswith("_")}
    tested = {c[1] for c in FUNCTIONALS} | {"class_center_sample"}
    assert names - tested == set(), sorted(names - tested)
    import paddle_tpu.nn.layers as rl
    classes = {n for n, o in vars(rl).items() if inspect.isclass(o)
               and o.__module__ == rl.__name__ and not n.startswith("_")}
    assert all(hasattr(P.nn, n) for n in classes), sorted(
        n for n in classes if not hasattr(P.nn, n))
