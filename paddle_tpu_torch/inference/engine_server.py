"""Engine-server entry point: one process, one port
``ContinuousBatchingEngine``, served over the fleet wire protocol
(``paddle_tpu_torch.inference.fleet``; the counterpart of the reference's
``tools/engine_server.py``, which imports the JAX package).

Launched by ``EngineProcess`` (or by hand)::

    python -m paddle_tpu_torch.inference.engine_server \\
        --config cfg.json --port-file port

The config JSON builds the engine deterministically —
:func:`build_engine_from_config` is also what a test or a chip run
imports to build the in-process twin with IDENTICAL weights (the same
seeded generator) and knobs.  The reference's keys keep their meaning::

    {
      "platform": "cpu",          // the CPU; anything else (or no key)
                                  // means the CUDA card, which must exist
      "host": "127.0.0.1", "port": 0,
      "engine_id": 0, "role": "mixed",
      "seed": 0,                  // the weights' generator seed
      "slots": 4, "num_blocks": 64, "block_size": 4, "chunk": null,
      "mixed_step": true, "enable_prefix_cache": true,
      "kv_dtype": null, "sampling": false,
      "warm": {"prompt_len": 12, "budget": 4},   // optional warm-up
      "fault_spec": "hang:rpc.recv:ms=2000"      // optional, in-process
    }

and the port adds the model and the engine keys of a full-width card
fleet: ``"model"`` — ``"tiny"`` (the default: ``llama_tiny_config()``,
the reference fleet's model) or ``"7b"`` (Llama-2-7B widths) —,
``"dtype"`` (``"float32"`` / ``"bfloat16"``), ``"layers"`` (cut the
depth), and ``"max_seq_len"`` and ``"prefill_buckets"`` (``"auto"`` or
a list).  The weights are
``LlamaForCausalLM(cfg, generator=torch.Generator(device)
.manual_seed(seed))``, so a 7B server holds the same weights as an
in-process 7B model built from the same seed on the card.

The listening address is published by WRITING ``host:port`` to
``--port-file`` via rename (the parent polls for it), AFTER the optional
warm-up — so a client's first step RPC never pays the kernels' first
load under its deadline; the engine's ``efficiency_stats`` is probed
then too, so its health payloads carry the efficiency block a remote
capacity plane reads.  The kernel launch counters are set to 0 just
before the address is published, and when the process leaves its serve
loop (a ``shutdown`` RPC) it prints one JSON line, ``{"engine_server":
{...}}``: the launch counters, the engine's step launches, the prompt
tokens it prefilled and the device's peak memory — a chip run reads
them from the process's log.  The process serves until a ``shutdown``
RPC, SIGTERM, or being killed.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

# every kernel launch counter of the serving path, by kernel variant:
# (module under paddle_tpu_torch.ops, wrapper, attribute)
LAUNCH_COUNTERS = {
    "ragged_paged_attention": ("paged_attention", "ragged_paged_attention",
                               "launches"),
    "ragged_paged_attention_int8": ("paged_attention",
                                    "ragged_paged_attention",
                                    "int8_launches"),
    "paged_attention": ("paged_attention", "paged_attention", "launches"),
    "paged_attention_int8": ("paged_attention", "paged_attention",
                             "int8_launches"),
    "ragged_paged_attention_generic": ("paged_attention",
                                       "ragged_paged_attention",
                                       "generic_launches"),
    "ragged_paged_attention_generic_int8": ("paged_attention",
                                            "ragged_paged_attention",
                                            "generic_int8_launches"),
    "paged_attention_generic": ("paged_attention", "paged_attention",
                                "generic_launches"),
    "paged_attention_generic_int8": ("paged_attention", "paged_attention",
                                     "generic_int8_launches"),
    "rope_qkv_epilogue": ("kernels", "rope_qkv_epilogue", "launches"),
    "rope_qkv_epilogue_amax": ("kernels", "rope_qkv_epilogue",
                               "amax_launches"),
    "dequant_int8": ("dequant", "dequant_int8", "launches"),
}


def _counter(name: str):
    mod, fn, attr = LAUNCH_COUNTERS[name]
    module = importlib.import_module("paddle_tpu_torch.ops." + mod)
    return getattr(module, fn), attr


def launch_counts() -> dict:
    """Every serving kernel's launch count in this process."""
    out = {}
    for name in LAUNCH_COUNTERS:
        fn, attr = _counter(name)
        out[name] = getattr(fn, attr)
    return out


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTERS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)


class CountedStep:
    """Counts the calls an engine makes to one of its steps (``__call__``
    or ``call_packed``); every other attribute is the step's."""

    def __init__(self, step):
        self.step, self.n = step, 0

    def __call__(self, *args, **kw):
        self.n += 1
        return self.step(*args, **kw)

    def call_packed(self, *args, **kw):
        self.n += 1
        return self.step.call_packed(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.step, name)


def count_steps(engine) -> dict:
    """Wrap the engine's steps in :class:`CountedStep`; returns them by
    kind (``mixed``, ``decode``, ``prefill``; a step the engine lacks is
    left out)."""
    steps = {}
    if engine.mixed is not None:
        engine.mixed = steps["mixed"] = CountedStep(engine.mixed)
    engine.decode_step = steps["decode"] = CountedStep(engine.decode_step)
    if engine.prefill_step is not None:
        engine.prefill_step = steps["prefill"] = CountedStep(
            engine.prefill_step)
    return steps


def build_engine_from_config(cfg: dict):
    """Deterministic engine from the config dict: the same config builds
    byte-identical weights in any process on the same device.  Returns
    ``(model_config, engine)``."""
    import torch
    from ..models.llama import (LlamaForCausalLM, llama_7b_config,
                                llama_tiny_config)
    from .serving import ContinuousBatchingEngine
    device = "cpu" if cfg.get("platform") == "cpu" else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "engine server config names no platform (the CUDA card) but "
            "no CUDA device is present; set \"platform\": \"cpu\" to serve "
            "on the CPU")
    mkw = {}
    if cfg.get("dtype") is not None:
        mkw["dtype"] = str(cfg["dtype"])
    if cfg.get("layers") is not None:
        mkw["num_hidden_layers"] = int(cfg["layers"])
    name = cfg.get("model", "tiny")
    if name == "tiny":
        model_cfg = llama_tiny_config(**mkw)
    elif name == "7b":
        model_cfg = llama_7b_config(**mkw)
    else:
        raise ValueError("engine server model must be 'tiny' or '7b'; got "
                         "%r" % (name,))
    model = LlamaForCausalLM(
        model_cfg, device=device,
        generator=torch.Generator(device).manual_seed(int(cfg.get("seed",
                                                                  0))))
    model.eval()
    kw = {}
    if cfg.get("engine_id") is not None:
        kw["engine_id"] = int(cfg["engine_id"])
    if cfg.get("max_seq_len") is not None:
        kw["max_seq_len"] = int(cfg["max_seq_len"])
    buckets = cfg.get("prefill_buckets")
    if buckets is not None:
        kw["prefill_buckets"] = (buckets if isinstance(buckets, str)
                                 else tuple(int(b) for b in buckets))
    engine = ContinuousBatchingEngine(
        model,
        max_batch_size=int(cfg.get("slots", 4)),
        num_blocks=int(cfg.get("num_blocks", 64)),
        block_size=int(cfg.get("block_size", 4)),
        mixed_step=bool(cfg.get("mixed_step", True)),
        prefill_chunk_size=cfg.get("chunk"),
        enable_prefix_cache=bool(cfg.get("enable_prefix_cache", True)),
        kv_dtype=cfg.get("kv_dtype"),
        sampling=bool(cfg.get("sampling", False)),
        role=cfg.get("role", "mixed"),
        device=device, **kw)
    return model_cfg, engine


def warm_engine(engine, warm: dict, vocab: int):
    """Optional warm-up before the port publishes: one throwaway request
    shaped like the workload, tokens from the top of the vocab so nothing
    registers in measured prefix families."""
    import numpy as np
    rng = np.random.RandomState(97)
    L = int(warm.get("prompt_len", 12))
    prompt = rng.randint(max(1, vocab - 50), vocab, (L,)).astype(np.int64)
    engine.add_request(prompt, max_new_tokens=int(warm.get("budget", 4)))
    engine.run_to_completion()
    engine.finished.clear()


def exit_record(engine, steps: dict, timings: dict) -> dict:
    """The JSON body the process prints when it leaves its serve loop."""
    import torch
    rec = {"engine_id": engine.engine_id, "pid": os.getpid(),
           "launches": launch_counts(),
           "steps": {k: s.n for k, s in steps.items()},
           "prefill_tokens": int(engine.prefill_tokens),
           "counters": dict(engine.counters), **timings}
    if engine.caches[0].key_cache.device.type == "cuda":
        rec["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated())
        rec["device"] = torch.cuda.get_device_name(0)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    help="engine config JSON path")
    ap.add_argument("--port-file", required=True,
                    help="file to publish host:port into (via rename)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)

    if cfg.get("fault_spec"):
        # in-process server-side faults (the env var works too — this
        # keeps a drill's config in one JSON)
        from ..testing import faults
        faults.configure(cfg["fault_spec"])

    from .fleet import EngineServer
    t0 = time.perf_counter()
    model_cfg, engine = build_engine_from_config(cfg)
    steps = count_steps(engine)
    t1 = time.perf_counter()
    if cfg.get("warm"):
        warm_engine(engine, cfg["warm"], int(model_cfg.vocab_size))
    # the serving step's efficiency block (an analytic count, env-gated)
    # rides every health payload, so a remote capacity plane publishes
    # this engine's serving-step MFU
    engine.efficiency_stats(compute=True)
    if engine.caches[0].key_cache.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    timings = {"build_s": t1 - t0, "warm_s": time.perf_counter() - t1}
    # the served traffic's counts start here, after the warm-up
    reset_launch_counts()
    for s in steps.values():
        s.n = 0
    engine.prefill_tokens = 0

    server = EngineServer(engine, host=cfg.get("host", "127.0.0.1"),
                          port=int(cfg.get("port", 0))).start()
    host, port = server.address
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{host}:{port}\n")
    os.replace(tmp, args.port_file)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    print(json.dumps({"engine_server": exit_record(engine, steps,
                                                   timings)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
