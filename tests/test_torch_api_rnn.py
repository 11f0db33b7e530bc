"""The recurrent layers and the beam search decoder of the paddle API,
port against reference on the CPU, on carried weights (the reference's
parameter names, ``weight_ih_l0_reverse`` ...): ``SimpleRNN``, ``LSTM``
and ``GRU`` over 2 layers in both directions, batch- and time-major,
from zero and from given initial states ``[layers * dirs, B, H]``; the
cells; the generic ``RNN`` and ``BiRNN`` over cells with
``sequence_length`` (the reverse direction starting at each example's
last valid step); ``BeamSearchDecoder`` through ``dynamic_decode``.
Outputs, final states and every input's gradient within 1e-5 of the
largest magnitude; the beam search's token ids equal."""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)
from torch_api_parity import (carried, compare_scaled, run_cases,
                              run_layers, seed_of)

TOL = 1e-5
B, T, IN, H = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def F(*shape):
    return lambda r: (r.randn(*shape) * 0.7).astype(np.float32)


def LENGTHS(*values):
    return lambda r: np.array(values, np.int64)


def _states(n_state, layers_dirs, time_major):
    one = F(layers_dirs, B, H)
    return [one] if n_state == 1 else [lambda r: [one(r), one(r)]]


MULTI = [
    (cls, direction, time_major, given)
    for cls in ("SimpleRNN", "LSTM", "GRU")
    for direction, time_major, given in (("forward", False, False),
                                         ("bidirect", False, True),
                                         ("bidirect", True, False))]


def _check_multi(case):
    cls, direction, time_major, given = case
    name = "%s-%s-%s-%s" % case
    R.seed(seed_of(name))
    kw = dict(num_layers=2, direction=direction, time_major=time_major)
    ref = getattr(R.nn, cls)(IN, H, **kw)
    port = carried(ref, getattr(P.nn, cls)(IN, H, **kw))
    assert sorted(ref.state_dict()) == sorted(port.state_dict())
    x = F(T, B, IN) if time_major else F(B, T, IN)
    ndirs = 2 if direction == "bidirect" else 1
    makers = [x] + (_states(2 if cls == "LSTM" else 1, 2 * ndirs,
                            time_major) if given else [])
    ref_out, port_out = run_layers(ref, port, makers, seed_of(name))
    compare_scaled(ref_out, port_out, TOL)


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_multi_layer_rnns_match_reference(cls):
    run_cases([c for c in MULTI if c[0] == cls], _check_multi)


def test_simple_rnn_relu_matches_reference():
    R.seed(3)
    ref = R.nn.SimpleRNN(IN, H, activation="relu")
    port = carried(ref, P.nn.SimpleRNN(IN, H, activation="relu"))
    compare_scaled(*run_layers(ref, port, [F(B, T, IN)], 3), TOL)


CELLS = [("SimpleRNNCell", [F(B, IN), F(B, H)]),
         ("SimpleRNNCell", [F(B, IN)]),
         ("LSTMCell", [F(B, IN), lambda r: [F(B, H)(r), F(B, H)(r)]]),
         ("LSTMCell", [F(B, IN)]),
         ("GRUCell", [F(B, IN), F(B, H)]),
         ("GRUCell", [F(B, IN)])]


def test_cells_match_reference():
    def check(case):
        cls, makers = case
        R.seed(seed_of(cls))
        ref = getattr(R.nn, cls)(IN, H)
        port = carried(ref, getattr(P.nn, cls)(IN, H))
        compare_scaled(*run_layers(ref, port, makers, seed_of(cls)), TOL)
    run_cases(CELLS, check)


def _wrapped(pkg, cell_cls, bi, time_major, seed):
    pkg.seed(seed)
    if bi:
        return pkg.nn.BiRNN(getattr(pkg.nn, cell_cls)(IN, H),
                            getattr(pkg.nn, cell_cls)(IN, H),
                            time_major=time_major)
    return pkg.nn.RNN(getattr(pkg.nn, cell_cls)(IN, H), is_reverse=True,
                      time_major=time_major)


SEQ = [(cell, bi, tm) for cell in ("LSTMCell", "GRUCell", "SimpleRNNCell")
       for bi, tm in ((True, False), (False, True))]


def test_rnn_and_birnn_with_sequence_length_match_reference():
    def check(case):
        cell, bi, tm = case
        seed = seed_of("%s%s%s" % case)
        ref = _wrapped(R, cell, bi, tm, seed)
        port = carried(ref, _wrapped(P, cell, bi, tm, seed))
        x = F(T, B, IN) if tm else F(B, T, IN)
        ref_layer = lambda *a: ref(a[0], sequence_length=a[1])  # noqa
        port_layer = lambda *a: port(a[0], sequence_length=a[1])  # noqa
        compare_scaled(*run_layers(ref_layer, port_layer,
                                   [x, LENGTHS(5, 3, 1)], seed), TOL)
    run_cases(SEQ, check)


def test_sequence_length_freezes_finished_states():
    """A finished example keeps its last state and emits zeros; the
    reverse direction starts at its last valid step."""
    P.seed(1)
    rnn = P.nn.BiRNN(P.nn.GRUCell(IN, H), P.nn.GRUCell(IN, H))
    x = np.random.RandomState(1).randn(2, T, IN).astype(np.float32)
    out, (h_fw, h_bw) = rnn(P.to_tensor(x),
                            sequence_length=P.to_tensor(np.array(
                                [T, 2], np.int64)))
    o = out.numpy()
    assert np.all(o[1, 2:] == 0)
    np.testing.assert_array_equal(h_fw.numpy()[1], o[1, 1, :H])
    np.testing.assert_array_equal(h_bw.numpy()[1], o[1, 0, H:])
    short, _ = rnn(P.to_tensor(x[1:, :2]))
    np.testing.assert_allclose(o[1, :2], short.numpy()[0], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_multi_layer_sequence_length_raises_as_the_reference(cls):
    x = np.zeros((B, T, IN), np.float32)
    lengths = np.array([5, 3, 1], np.int64)
    for pkg in (R, P):
        layer = getattr(pkg.nn, cls)(IN, H)
        with pytest.raises(NotImplementedError):
            layer(pkg.to_tensor(x), sequence_length=pkg.to_tensor(lengths))


def _decoder(pkg, seed, beam=3, vocab=11):
    pkg.seed(seed)
    cell = pkg.nn.GRUCell(8, 8)
    emb = pkg.nn.Embedding(vocab, 8)
    head = pkg.nn.Linear(8, vocab)
    return cell, emb, head, pkg.nn.BeamSearchDecoder(
        cell, 0, vocab - 1, beam, embedding_fn=emb, output_fn=head)


@pytest.mark.parametrize("beam,steps", [(3, 6), (4, 9)])
def test_beam_search_tokens_equal_the_reference(beam, steps):
    r_cell, r_emb, r_head, r_dec = _decoder(R, 5, beam)
    p_cell, p_emb, p_head, p_dec = _decoder(P, 5, beam)
    for r, p in ((r_cell, p_cell), (r_emb, p_emb), (r_head, p_head)):
        carried(r, p)
    h0 = np.random.RandomState(beam).randn(2, 8).astype(np.float32)
    r_ids, r_scores, r_len = R.nn.dynamic_decode(
        r_dec, R.to_tensor(h0), max_step_num=steps, return_length=True)
    p_ids, p_scores, p_len = P.nn.dynamic_decode(
        p_dec, P.to_tensor(h0), max_step_num=steps, return_length=True)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(r_ids.numpy()))
    np.testing.assert_array_equal(p_len.numpy(), np.asarray(r_len.numpy()))
    want = np.asarray(r_scores.numpy())
    assert np.abs(p_scores.numpy() - want).max() <= TOL * np.abs(want).max()
    tiled = P.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        P.to_tensor(h0), beam).numpy()
    np.testing.assert_array_equal(tiled, np.asarray(
        R.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
            R.to_tensor(h0), beam).numpy()))


def test_every_recurrent_and_decoder_class_is_ported():
    import inspect
    import paddle_tpu.nn.decode as rd
    import paddle_tpu.nn.rnn as rr
    names = {n for m in (rr, rd) for n, o in vars(m).items()
             if (inspect.isclass(o) or inspect.isfunction(o))
             and o.__module__ == m.__name__ and not n.startswith("_")}
    assert all(hasattr(P.nn, n) for n in names), sorted(
        n for n in names if not hasattr(P.nn, n))
