"""The API's ``nn``, ``amp`` and clips, port against reference on the CPU:
the functionals of ``activation``, ``common``, ``norm`` and ``loss`` on
the same seeded inputs (forward 1e-6 with the same dtype, gradients
1e-5); layers on carried weights; attention by each of its routes (the
flash kernels' plain versions, the masked chunked path, the einsum path
with the flag off); the dtypes ``auto_cast`` O1 and O2 give each op; the
three gradient clips and ``GradScaler``."""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.testing.parity import api_state_from_paddle_tpu
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)
from torch_api_parity import (assert_close, compare_outputs, dtype_name,
                              run_both, run_cases, run_one, seed_of)

FWD_TOL, GRAD_TOL = 1e-6, 1e-5
FLASH = (fa.flash_fwd, fa.flash_bwd_fused, fa.flash_bwd_two_kernel)


@pytest.fixture(autouse=True)
def on_cpu():
    flags = {"use_pallas_kernels": True}
    with device_guard("cpu"):
        yield
    R.set_flags(flags)
    P.set_flags(flags)


def F(*shape, lo=None, hi=None):
    if lo is not None:
        return lambda r: r.uniform(lo, hi, shape).astype(np.float32)
    return lambda r: r.randn(*shape).astype(np.float32)


def I(*shape, hi=5):
    return lambda r: r.randint(0, hi, shape).astype(np.int64)


def PROB(*shape):
    return lambda r: r.uniform(0.05, 0.95, shape).astype(np.float32)


def SIGN(*shape):
    return lambda r: np.where(r.rand(*shape) > 0.5, 1.0, -1.0).astype(
        np.float32)


def LOGP(*shape):
    def make(r):
        x = r.randn(*shape).astype(np.float32)
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)
    return make


def SOFT(*shape):
    def make(r):
        x = r.rand(*shape).astype(np.float32) + 0.1
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)
    return make


def CONST(v):
    return lambda r: v


NF = "nn.functional."
FUNCTIONALS = [
    ("relu", [F(3, 4)], {}), ("relu6", [F(3, 4, lo=-3, hi=8)], {}),
    ("gelu", [F(3, 4)], {}), ("gelu_tanh", [F(3, 4)], dict(approximate=True)),
    ("silu", [F(3, 4)], {}), ("swish", [F(3, 4)], {}),
    ("softmax", [F(3, 4)], {}), ("log_softmax", [F(3, 4)], dict(axis=0)),
    ("softplus", [F(3, 4)], dict(beta=2.0)), ("softsign", [F(3, 4)], {}),
    ("sigmoid", [F(3, 4)], {}), ("tanh", [F(3, 4)], {}),
    ("hardtanh", [F(3, 4)], {}), ("hardsigmoid", [F(3, 4, lo=-5, hi=5)], {}),
    ("hardswish", [F(3, 4, lo=-5, hi=5)], {}),
    ("leaky_relu", [F(3, 4)], dict(negative_slope=0.2)),
    ("elu", [F(3, 4)], dict(alpha=0.7)), ("celu", [F(3, 4)], dict(alpha=2.0)),
    ("selu", [F(3, 4)], {}), ("mish", [F(3, 4)], {}),
    ("tanhshrink", [F(3, 4)], {}), ("softshrink", [F(3, 4)], {}),
    ("hardshrink", [F(3, 4)], {}), ("prelu", [F(2, 3, 4), F(3)], {}),
    ("glu", [F(3, 4)], {}), ("maxout", [F(2, 4, 3)], dict(groups=2)),
    ("log_sigmoid", [F(3, 4)], {}), ("thresholded_relu", [F(3, 4)], {}),
    ("rrelu", [F(3, 4)], {}), ("swiglu", [F(3, 4), F(3, 4)], {}),
    ("linear", [F(3, 4), F(4, 5), F(5)], {}),
    ("dropout_eval", [F(3, 4)], dict(p=0.3, training=False)),
    ("dropout_infer", [F(3, 4)], dict(p=0.3, training=False,
                                      mode="downscale_in_infer")),
    ("embedding", [I(2, 3, hi=6), F(6, 4)], dict(padding_idx=2)),
    ("one_hot", [I(5, hi=4)], dict(num_classes=4)),
    ("label_smooth", [SOFT(3, 4)], dict(epsilon=0.2)),
    ("cosine_similarity", [F(3, 4), F(3, 4)], {}),
    ("normalize", [F(3, 4)], dict(p=3, axis=0)),
    ("bilinear", [F(2, 3), F(2, 4), F(5, 3, 4), F(5)], {}),
    ("unfold", [F(1, 2, 5, 5)], dict(kernel_sizes=3, strides=2,
                                     paddings=1)),
    ("fold", [F(1, 8, 4)], dict(output_sizes=[3, 3], kernel_sizes=2)),
    ("pixel_shuffle", [F(1, 8, 2, 3)], dict(upscale_factor=2)),
    ("pixel_unshuffle", [F(1, 2, 4, 6)], dict(downscale_factor=2)),
    ("interpolate_nearest", [F(1, 2, 3, 4)], dict(scale_factor=2)),
    ("interpolate_bilinear", [F(1, 2, 3, 4)], dict(size=[5, 7],
                                                   mode="bilinear")),
    ("interpolate_corners", [F(1, 2, 3, 4)], dict(
        size=[6, 8], mode="bilinear", align_corners=True)),
    ("interpolate_area", [F(1, 2, 4, 6)], dict(size=[2, 3], mode="area")),
    ("zeropad2d", [F(1, 2, 3, 4)], dict(padding=[1, 0, 2, 1])),
    ("pad", [F(1, 2, 3, 4)], dict(pad=[1, 1, 1, 1], mode="replicate")),
    ("batch_norm", [F(4, 3, 2), F(3), F(3, lo=0.5, hi=2.0), F(3), F(3)],
     {}),
    ("layer_norm", [F(3, 4, 6), CONST(6), F(6), F(6)], {}),
    ("rms_norm", [F(3, 8), F(8)], {}),
    ("instance_norm", [F(2, 3, 5)], {}),
    ("group_norm", [F(2, 4, 5)], dict(num_groups=2)),
    ("local_response_norm", [F(1, 6, 3, 3)], dict(size=3)),
    ("cross_entropy", [F(6, 5), I(6)], {}),
    ("cross_entropy_ignore", [F(2, 3, 5), I(2, 3)], dict(ignore_index=1)),
    ("cross_entropy_weight", [F(6, 5), I(6)], dict(
        weight=np.linspace(0.5, 2.0, 5).astype(np.float32))),
    ("cross_entropy_smooth", [F(6, 5), I(6)], dict(label_smoothing=0.1)),
    ("cross_entropy_soft", [F(6, 5), SOFT(6, 5)], dict(soft_label=True)),
    ("cross_entropy_sum", [F(6, 5), I(6)], dict(reduction="sum")),
    ("softmax_with_cross_entropy", [F(6, 5), I(6, 1)], {}),
    ("binary_cross_entropy", [PROB(6), I(6, hi=2)], {}),
    ("binary_cross_entropy_with_logits", [F(6), PROB(6)],
     dict(pos_weight=np.float32(1.5))),
    ("mse_loss", [F(3, 4), F(3, 4)], {}),
    ("l1_loss", [F(3, 4), F(3, 4)], dict(reduction="sum")),
    ("nll_loss", [LOGP(6, 5), I(6)], {}),
    ("kl_div", [LOGP(3, 4), SOFT(3, 4)], dict(reduction="batchmean")),
    ("smooth_l1_loss", [F(3, 4), F(3, 4)], {}),
    ("margin_ranking_loss", [F(6), F(6), SIGN(6)], dict(margin=0.1)),
    ("cosine_embedding_loss", [F(4, 3), F(4, 3), SIGN(4)], {}),
    ("hinge_embedding_loss", [F(6), SIGN(6)], {}),
    ("triplet_margin_loss", [F(4, 3), F(4, 3), F(4, 3)], {}),
    ("log_loss", [PROB(6), I(6, hi=2)], {}),
    ("square_error_cost", [F(3, 4), F(3, 4)], {}),
    ("sigmoid_focal_loss", [F(6), I(6, hi=2)], {}),
    ("ctc_loss", [LOGP(5, 2, 4), CONST(np.array([[1, 2], [3, 3]],
                                                np.int64)),
                  CONST(np.array([5, 4], np.int64)),
                  CONST(np.array([2, 2], np.int64))], {}),
    ("soft_margin_loss", [F(6), SIGN(6)], {}),
    ("multi_margin_loss", [F(4, 5), I(4)], {}),
    ("multi_label_soft_margin_loss", [F(4, 5), I(4, 5, hi=2)], {}),
    ("poisson_nll_loss", [F(6), PROB(6)], {}),
    ("gaussian_nll_loss", [F(6), F(6), PROB(6)], {}),
    ("dice_loss", [SOFT(2, 3, 4), I(2, 3, 1, hi=4)], {}),
    ("npair_loss", [F(4, 3), F(4, 3), I(4, hi=2)], {}),
    ("margin_cross_entropy", [F(4, 5, lo=-0.9, hi=0.9), I(4)], {}),
]
NAME_OF = {"gelu_tanh": "gelu", "dropout_eval": "dropout",
           "dropout_infer": "dropout", "interpolate_nearest": "interpolate",
           "interpolate_bilinear": "interpolate",
           "interpolate_corners": "interpolate",
           "interpolate_area": "interpolate"}


def _fn_name(case):
    n = case[0]
    return NAME_OF.get(n, n.split("_ignore")[0].split("_weight")[0]
                       .split("_smooth")[0].split("_soft")[0]
                       .split("_sum")[0]
                       if n.startswith("cross_entropy") else n)


def _check_functional(case):
    ref, port = run_both(NF + _fn_name(case), case[1], case[2],
                         seed=seed_of(case[0]))
    compare_outputs(ref, port, FWD_TOL, GRAD_TOL)


# in groups of 8 a test: the file stays under 39 tests (see
# test_torch_api_ops.py's GROUPS)
GROUPS = [FUNCTIONALS[i:i + 8] for i in range(0, len(FUNCTIONALS), 8)]


@pytest.mark.parametrize("group", GROUPS,
                         ids=["%s-%s" % (g[0][0], g[-1][0]) for g in GROUPS])
def test_functionals_match_reference(group):
    run_cases(group, _check_functional)


def test_every_ported_functional_is_tested():
    tested = {_fn_name(c) for c in FUNCTIONALS}
    import paddle_tpu_torch.nn.functional as PF
    # conv, pooling, vision and the extended set are held by
    # test_torch_api_conv.py and test_torch_api_vision.py
    elsewhere = {"paddle_tpu_torch.nn.functional." + m
                 for m in ("conv", "pooling", "vision", "extended")}
    public = {n for n in dir(PF) if not n.startswith("_")
              and callable(getattr(PF, n)) and not n.endswith("_")
              and n not in ("activation", "common", "norm", "loss")
              and getattr(PF, n).__module__ not in elsewhere}
    untested = public - tested - {
        "dropout2d", "dropout3d", "alpha_dropout", "upsample",
        "gumbel_softmax", "scaled_dot_product_attention",
        "flash_attention"}
    assert not untested, sorted(untested)


# -- attention by route ----------------------------------------------------------
def _qkv(rng, B=2, S=8, H=2, D=16, Sk=None):
    Sk = Sk or S
    return [rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, Sk, H, D).astype(np.float32),
            rng.randn(B, Sk, H, D).astype(np.float32)]


ATTENTION = [
    ("flash_causal", dict(is_causal=True), None, True),
    ("flash_full", dict(), None, True),
    ("flash_rect", dict(is_causal=True), "rect", True),
    ("mask_bool", dict(), "bool", True),
    ("mask_float_causal", dict(is_causal=True), "float", True),
    ("einsum_causal", dict(is_causal=True), None, False),
    ("einsum_mask", dict(), "float", False),
]


def _check_route(case):
    name, kw, mask, flag = case
    rng = np.random.RandomState(seed_of(name))
    vals = _qkv(rng, Sk=12 if mask == "rect" else None)
    if mask == "bool":
        kw = dict(kw, attn_mask=(rng.rand(2, 2, 8, 8) > 0.3))
    elif mask == "float":
        kw = dict(kw, attn_mask=(rng.randn(1, 1, 8, 8) * 0.5).astype(
            np.float32))
    R.set_flags({"use_pallas_kernels": flag})
    P.set_flags({"use_pallas_kernels": flag})
    before = [f.launches for f in FLASH]
    ref = run_one(R, lambda p: p.nn.functional.scaled_dot_product_attention,
                  vals, kw, 5)
    port = run_one(P, lambda p: p.nn.functional.scaled_dot_product_attention,
                   vals, kw, 5)
    compare_outputs(ref, port, 1e-5, GRAD_TOL)
    assert [f.launches for f in FLASH] == before


def test_sdpa_routes_match_reference():
    run_cases(ATTENTION, _check_route)


def test_flash_attention_function_returns_out_and_none():
    rng = np.random.RandomState(0)
    q, k, v = (P.to_tensor(a) for a in _qkv(rng))
    out, sm = P.nn.functional.flash_attention(q, k, v, causal=True)
    assert sm is None
    want = P.nn.functional.scaled_dot_product_attention(q, k, v,
                                                        is_causal=True)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_sdpa_dropout_takes_the_einsum_path():
    rng = np.random.RandomState(1)
    q, k, v = (P.to_tensor(a) for a in _qkv(rng))
    P.seed(0)
    a = P.nn.functional.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    P.seed(0)
    b = P.nn.functional.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    c = P.nn.functional.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    no_drop = P.nn.functional.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, training=False)
    assert not np.array_equal(a.numpy(), no_drop.numpy())


# -- layers on carried weights ---------------------------------------------------
def _carry(ref_layer, port_layer):
    state = {k: v.numpy() for k, v in ref_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(
        api_state_from_paddle_tpu(state))
    assert not missing and not unexpected
    assert list(port_layer.state_dict()) == list(ref_layer.state_dict())


LAYERS = [
    ("linear", lambda pk: pk.nn.Linear(4, 3), (2, 4)),
    ("linear_nobias", lambda pk: pk.nn.Linear(4, 3, bias_attr=False),
     (2, 4)),
    ("sequential", lambda pk: pk.nn.Sequential(
        pk.nn.Linear(4, 8), pk.nn.GELU(), pk.nn.LayerNorm(8),
        pk.nn.RMSNorm(8), pk.nn.Linear(8, 3), pk.nn.Tanh()), (5, 4)),
    ("encoder_layer", lambda pk: pk.nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0), (2, 5, 8)),
    ("encoder_pre_norm", lambda pk: pk.nn.TransformerEncoder(
        pk.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                      normalize_before=True,
                                      activation="gelu"), 2), (2, 5, 8)),
    ("groupnorm_prelu", lambda pk: pk.nn.Sequential(
        pk.nn.GroupNorm(2, 4), pk.nn.PReLU(4)), (2, 4, 3)),
    ("batchnorm_eval", lambda pk: pk.nn.BatchNorm1D(3).eval(), (4, 3, 2)),
    ("bilinear", lambda pk: pk.nn.Bilinear(3, 4, 2), None),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_on_carried_weights_matches_reference(case):
    name, make, shape = case
    R.seed(seed_of(name) % 1000)
    ref = make(R)
    port = make(P)
    _carry(ref, port)
    rng = np.random.RandomState(seed_of(name))
    if shape is None:
        vals = [rng.randn(2, 3).astype(np.float32),
                rng.randn(2, 4).astype(np.float32)]
    else:
        vals = [rng.randn(*shape).astype(np.float32)]
    r_out, _ = run_one(R, lambda p: ref, vals, {}, 9)
    p_out, _ = run_one(P, lambda p: port, vals, {}, 9)
    assert_close(p_out.numpy(), r_out.numpy(), 1e-5, name)
    for (k, a), (k2, b) in zip(ref.named_parameters(),
                               port.named_parameters()):
        assert k == k2
        if a.grad is None:
            assert b.grad is None or not np.any(b.grad.numpy()), k
        else:
            assert_close(b.grad.numpy(), np.asarray(a.grad.numpy()),
                         GRAD_TOL, k)


def test_batchnorm_training_updates_running_stats_as_the_reference():
    R.seed(0)
    ref, port = R.nn.BatchNorm1D(3), P.nn.BatchNorm1D(3)
    _carry(ref, port)
    x = np.random.RandomState(0).randn(4, 3, 5).astype(np.float32)
    for _ in range(2):
        a, b = ref(R.to_tensor(x)), port(P.to_tensor(x))
    assert_close(b.numpy(), a.numpy(), 1e-5)
    for k, v in ref.state_dict().items():
        assert_close(port.state_dict()[k].numpy(), np.asarray(v.numpy()),
                     1e-6, k)


def test_layer_api():
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(3, 2)
            self.blocks = P.nn.LayerList([P.nn.Linear(2, 2)
                                          for _ in range(2)])
            self.register_buffer("steps", P.to_tensor([0.0]))
            self.register_buffer("scratch", P.to_tensor([1.0]),
                                 persistable=False)
            self.scale = self.create_parameter(
                [1], default_initializer=P.nn.initializer.Constant(2.0))

        def forward(self, x):
            h = self.fc(x)
            for b in self.blocks:
                h = b(h)
            return h * self.scale

    net = Net()
    assert list(net.state_dict()) == [
        "scale", "fc.weight", "fc.bias", "blocks.0.weight", "blocks.0.bias",
        "blocks.1.weight", "blocks.1.bias", "steps"] or set(
        net.state_dict()) == {"scale", "fc.weight", "fc.bias",
                              "blocks.0.weight", "blocks.0.bias",
                              "blocks.1.weight", "blocks.1.bias", "steps"}
    assert len(net.parameters()) == 7 and len(net.sublayers()) == 4
    assert "scratch" not in net.state_dict()
    calls = []
    h1 = net.register_forward_pre_hook(lambda m, inp: calls.append("pre"))
    h2 = net.register_forward_post_hook(
        lambda m, inp, out: calls.append("post"))
    out = net(P.to_tensor(np.ones((4, 3), np.float32)))
    h1.remove()
    h2.remove()
    net(P.to_tensor(np.ones((4, 3), np.float32)))
    assert calls == ["pre", "post"] and out.shape == [4, 2]
    out.sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    net.eval()
    assert not net.training and not net.blocks[1].training
    net.train()
    w = net.fc.weight
    net.to(dtype="float64")
    assert net.fc.weight is w and w.dtype == P.float64
    assert net.steps.dtype == P.float64
    net.float()
    assert w.dtype == P.float32
    missing, unexpected = net.set_state_dict({"fc.weight": np.zeros(
        (3, 2), np.float32), "nope": np.zeros(1)})
    assert unexpected == ["nope"] and "fc.bias" in missing
    assert not np.any(net.fc.weight.numpy())
    x = P.to_tensor(np.ones((2, 3), np.float32))
    state = {k: v._value * 0 for k, v in net.state_dict().items()}
    assert not np.any(net.functional_call(state, x).numpy())
    own = {k: v._value + 1 for k, v in net.state_dict().items()}
    want = net.functional_call(own, x).numpy()
    assert np.any(want) and not np.any(net(x).numpy())
    seq = P.nn.Sequential(P.nn.Linear(2, 2), P.nn.ReLU())
    assert isinstance(seq[1], P.nn.ReLU) and len(seq) == 2
    pl = P.nn.ParameterList([P.nn.Parameter(np.ones(2, np.float32))])
    assert len(pl) == 1 and pl[0].shape == [2]
    ld = P.nn.LayerDict({"a": P.nn.Linear(1, 1)})
    assert "a" in ld and len(ld) == 1


# -- amp -------------------------------------------------------------------------
AMP_OPS = ["matmul", "linear", "exp", "sum", "add", "relu", "softmax",
           "layer_norm", "cross_entropy", "scaled_dot_product_attention",
           "flash_attention_pallas", "einsum", "mean", "conv2d", "pow",
           "tanh", "embedding"]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_op_dtypes_match_reference(level):
    """The dtype each op runs in under ``auto_cast`` at ``level``, by the
    lists, and what actual ops return inside the scope."""
    from paddle_tpu.amp import _amp_dtype_for_op
    from paddle_tpu_torch.amp import amp_dtype_for_op
    for op in AMP_OPS:
        for white, black in (((), ()), (("exp",), ("matmul",))):
            want = _amp_dtype_for_op(op, level, "bfloat16", white, black)
            got = amp_dtype_for_op(op, level, "bfloat16", white, black)
            assert (None if want is None else str(np.dtype(want))) == (
                None if got is None else P.core.dtypes.dtype_name(got)), op
    rng = np.random.RandomState(0)
    x = rng.randn(4, 8).astype(np.float32)
    w = rng.randn(8, 8).astype(np.float32)
    q = rng.randn(1, 4, 2, 8).astype(np.float32)

    def probe(pk):
        xs, ws = pk.to_tensor(x, stop_gradient=False), pk.to_tensor(w)
        qs = pk.to_tensor(q)
        F_ = pk.nn.functional
        with pk.amp.auto_cast(level=level, dtype="bfloat16"):
            outs = {"matmul": pk.matmul(xs, ws), "linear": F_.linear(xs, ws),
                    "exp": pk.exp(xs), "add": xs + xs,
                    "relu": F_.relu(xs), "softmax": F_.softmax(xs),
                    "sum": pk.sum(xs),
                    "sdpa": F_.scaled_dot_product_attention(
                        qs, qs, qs, is_causal=True),
                    "mm_then_exp": pk.exp(pk.matmul(xs, ws)),
                    "mm_then_relu": F_.relu(pk.matmul(xs, ws))}
        loss = pk.sum(outs["linear"].astype("float32"))
        loss.backward()
        res = {k: dtype_name(v) for k, v in outs.items()}
        res["grad"] = dtype_name(xs.grad)
        return res
    assert probe(P) == probe(R)


def test_decorate_o2_casts_parameters_and_keeps_master_weights():
    model = P.nn.Linear(4, 4)
    opt = P.optimizer.AdamW(1e-2, parameters=model.parameters())
    model, opt = P.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    assert model.weight.dtype == P.bfloat16 and opt._multi_precision
    x = P.to_tensor(np.ones((2, 4), np.float32))
    with P.amp.auto_cast(level="O2"):
        loss = model(x).astype("float32").sum()
    loss.backward()
    opt.step()
    st = opt.state(model.weight.name)
    assert st["master"].dtype == P.float32
    assert model.weight.dtype == P.bfloat16


# -- clips and the scaler ----------------------------------------------------------
@pytest.mark.parametrize("clip", ["ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm"])
def test_clip_matches_reference(clip):
    rng = np.random.RandomState(seed_of(clip))
    grads = [rng.randn(3, 4).astype(np.float32) * 3,
             rng.randn(5).astype(np.float32) * 0.1]
    args = {"ClipGradByValue": (0.5,), "ClipGradByNorm": (1.0,),
            "ClipGradByGlobalNorm": (1.0,)}[clip]
    outs = []
    for pk in (R, P):
        c = getattr(pk.nn, clip)(*args)
        pairs = [(pk.to_tensor(np.zeros_like(g)), pk.to_tensor(g))
                 for g in grads] + [(pk.to_tensor([0.0]), None)]
        outs.append([None if g is None else g.numpy() for _, g in c(pairs)])
    for a, b in zip(*outs):
        if a is None:
            assert b is None
        else:
            assert_close(b, np.asarray(a), 1e-6)


def test_optimizer_grad_clip_matches_reference():
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 3).astype(np.float32)
    g = rng.randn(4, 3).astype(np.float32) * 5
    outs = []
    for pk in (R, P):
        p = pk.nn.Parameter(w0.copy())
        opt = pk.optimizer.AdamW(0.1, parameters=[p],
                                 grad_clip=pk.nn.ClipGradByGlobalNorm(1.0))
        (p * pk.to_tensor(g)).sum().backward()
        opt.step()
        outs.append(np.asarray(p.numpy()))
    assert_close(outs[1], outs[0], 1e-6)


def test_grad_scaler_matches_reference():
    rng = np.random.RandomState(0)
    w0 = rng.randn(3).astype(np.float32)
    runs = []
    for pk in (R, P):
        p = pk.nn.Parameter(w0.copy())
        opt = pk.optimizer.SGD(0.1, parameters=[p])
        sc = pk.amp.GradScaler(init_loss_scaling=1024.0,
                               incr_every_n_steps=2)
        seen = []
        for step in range(5):
            bad = step == 2
            x = pk.to_tensor(np.array([1.0, np.inf if bad else 2.0, 3.0],
                                      np.float32))
            loss = (p * x).sum()
            sc.scale(loss).backward()
            sc.step(opt)
            sc.update()
            opt.clear_grad()
            seen.append((float(sc.get_loss_scaling()),
                         np.asarray(p.numpy()).tolist()))
        runs.append(seen)
    for (sa, pa), (sb, pb) in zip(*runs):
        assert sa == sb
        np.testing.assert_allclose(pb, pa, rtol=1e-6)
    sc = P.amp.GradScaler()
    opt = P.optimizer.SGD(0.1, parameters=[P.nn.Parameter(w0.copy())])
    sc.unscale_(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        sc.unscale_(opt)
