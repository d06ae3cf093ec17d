"""Kill-and-resume with the PyTorch/CUDA port: crash-safe multi-tenant
serving.

Launches a `BankSessionServer` with a write-ahead journal in a child
process, streams a few chunks for every tenant, then SIGKILLs the child
mid-flight — with chunks still queued and outputs still undelivered.
This process calls `BankSessionServer.recover(journal, program)` and
keeps serving; at the end every tenant's joined stream is bit-exact
against an uninterrupted numpy-oracle run.

    PYTHONPATH=src python examples/port_session_recovery.py               # the GPU
    PYTHONPATH=src python examples/port_session_recovery.py --device cpu  # plain
"""
import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--sessions", type=int, default=8)
ap.add_argument("--taps", type=int, default=31)
ap.add_argument("--chunk", type=int, default=256)
ap.add_argument("--device", default=None,
                help="where the kernels run: the GPU by default; 'cpu' runs "
                     "their plain PyTorch versions")
args = ap.parse_args()

# refuse at once, before the child starts, where the default card is missing
from repro_torch.kernels import resolve_device                 # noqa: E402

device = str(resolve_device(args.device))

workdir = tempfile.mkdtemp(prefix="blmac_recovery_")
journal = os.path.join(workdir, "wal")

# phase 1 runs in a child so this script can SIGKILL it the way a real
# crash would: no atexit, no finally blocks, no flushes
VICTIM = f"""
import os, signal
import numpy as np
from repro_torch.compiler import compile_bank
from repro_torch.filters import spread_lowpass_qbank
from repro_torch.serving import BankSessionServer

prog = compile_bank(spread_lowpass_qbank(64, {args.taps}))
srv = BankSessionServer(prog, n_slots=4, auto_step=False, device={device!r},
                        journal={journal!r}, snapshot_every=2)
rng = np.random.default_rng(1)
sessions = [srv.open_session(np.arange(i, i + 4), session_id=f"tenant{{i}}")
            for i in range({args.sessions})]
for k in range(4):
    for i, s in enumerate(sessions):
        s.push(rng.integers(-128, 128, {args.chunk}).astype(np.int32))
    srv.step()
    for s in sessions:
        s.pull()
# leave work in flight: one more push per tenant, never stepped
for s in sessions:
    s.push(rng.integers(-128, 128, {args.chunk}).astype(np.int32))
print("victim: killing self with queued chunks and no clean shutdown",
      flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""

env = dict(os.environ)
env["PYTHONPATH"] = (os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "..", "src")
                     + os.pathsep + env.get("PYTHONPATH", ""))
res = subprocess.run([sys.executable, "-c", VICTIM], env=env,
                     capture_output=True, text=True)
print(res.stdout, end="")
assert res.returncode == -signal.SIGKILL, res.stderr
print(f"victim exited with {res.returncode} (SIGKILL); journal at {journal}")

# phase 2: recover in THIS process and finish the streams
from repro_torch.compiler import compile_bank                  # noqa: E402
from repro_torch.filters import (fir_bit_layers_batch,         # noqa: E402
                                 spread_lowpass_qbank)
from repro_torch.serving import BankSessionServer              # noqa: E402

qbank = spread_lowpass_qbank(64, args.taps)
prog = compile_bank(qbank)
srv = BankSessionServer.recover(journal, prog, n_slots=4, device=device,
                                auto_step=False)
print(f"recovered {len(srv.sessions)} sessions on {device}; "
      f"journal stats: {srv.journal.stats()}")

# replay the victim's RNG to know what it pushed, then stream more
rng = np.random.default_rng(1)
streams = [[] for _ in range(args.sessions)]
for _ in range(5):
    for i in range(args.sessions):
        streams[i].append(rng.integers(-128, 128, args.chunk)
                          .astype(np.int32))
outs = [[] for _ in range(args.sessions)]
sessions = [srv.sessions[f"tenant{i}"] for i in range(args.sessions)]


def pull_all():
    for i, s in enumerate(sessions):
        out = s.pull()
        if out.shape[1]:
            outs[i].append(out)


pull_all()              # whatever recovery regenerated
for k in range(3):      # keep serving after the crash
    for i, s in enumerate(sessions):
        chunk = rng.integers(-128, 128, args.chunk).astype(np.int32)
        streams[i].append(chunk)
        s.push(chunk)
    srv.step()
    pull_all()
srv.step()
pull_all()

# the victim delivered the first 4 chunks' worth of output before dying;
# everything AFTER that watermark must match the uninterrupted oracle
n_pre = 4 * args.chunk - (args.taps - 1)
for i in range(args.sessions):
    x = np.concatenate(streams[i])
    ref = fir_bit_layers_batch(x[None, :], qbank)[np.arange(i, i + 4), 0]
    got = np.concatenate(outs[i], axis=1)
    assert got.shape[1] == x.size - args.taps + 1 - n_pre, \
        f"tenant{i} lost or repeated samples"
    assert np.array_equal(got, ref[:, n_pre:n_pre + got.shape[1]]), \
        f"tenant{i} stream mismatch after recovery"
srv.close()
shutil.rmtree(workdir, ignore_errors=True)
print(f"all {args.sessions} tenants bit-exact across the crash "
      f"({got.shape[1]} post-crash samples each) — no duplicates, no gaps  OK")
