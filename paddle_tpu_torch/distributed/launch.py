"""The rank launcher: ``run_world`` starts one process per rank with
``subprocess`` (never a fork of a process that may have touched CUDA),
joins them into one ``torch.distributed`` world and returns what rank 0's
function returned.  The ranks meet through a file in the world's own
temporary directory (``file://``; no port to pick, so worlds started side
by side cannot collide).

Each rank runs ``python -m paddle_tpu_torch.distributed.launch`` with the
target ``"module:function"``; the function is called as ``fn(rank,
world_size, args)`` after the rank joined the world (``process_mesh.
init_world``), and rank 0's return value travels back pickled through a
file.  A rank that fails, or a world that outlives ``timeout``, stops
every rank and raises with the tail of each rank's output.
"""
from __future__ import annotations

import argparse
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

__all__ = ["run_world"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return ""
    return data[-n:].decode("utf-8", "replace")


def run_world(target: str, world_size: int, args=None,
              timeout: float = 600.0, env: Optional[Dict[str, str]] = None):
    """Run ``target`` on ``world_size`` ranks; returns rank 0's result.

    ``env`` adds to the ranks' environment (the repository root is put on
    ``PYTHONPATH``)."""
    with tempfile.TemporaryDirectory(prefix="ptt_world_") as tmp:
        args_path = os.path.join(tmp, "args.pkl")
        out_path = os.path.join(tmp, "out.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        child_env = dict(os.environ)
        child_env.update(env or {})
        child_env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in child_env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs, logs = [], []
        failed = None
        try:
            for r in range(world_size):
                log = os.path.join(tmp, "rank%d.log" % r)
                logs.append(log)
                with open(log, "wb") as fh:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "paddle_tpu_torch.distributed.launch",
                         "--target", target, "--rank", str(r),
                         "--world", str(world_size), "--init", init,
                         "--args", args_path, "--out", out_path],
                        stdout=fh, stderr=subprocess.STDOUT, env=child_env,
                        cwd=_ROOT))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = "rank %d exited with %d" % (bad[0],
                                                         codes[bad[0]])
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = "the world outlived its %.0f s" % timeout
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            if failed:
                for r, log in enumerate(logs):
                    sys.stderr.write("---- rank %d ----\n%s\n"
                                     % (r, _tail(log)))
        if failed:
            raise RuntimeError("run_world(%s, %d): %s; rank outputs above"
                               % (target, world_size, failed))
        with open(out_path, "rb") as f:
            return pickle.load(f)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--args", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    import torch.distributed as dist
    from .process_mesh import init_world
    with open(a.args, "rb") as f:
        args = pickle.load(f)
    mod, fn = a.target.split(":")
    target = getattr(importlib.import_module(mod), fn)
    init_world(a.rank, a.world, a.init)
    try:
        res = target(a.rank, a.world, args)
        if a.rank == 0:
            with open(a.out + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(a.out + ".tmp", a.out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
