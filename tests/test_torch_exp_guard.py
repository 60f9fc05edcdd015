"""A guard for torch's CPU exp fault (ROADMAP C.3): now and then the first
vectorized ``exp`` of a process, after a float32 einsum has started the
intra-op threads, returned one parallel chunk (32,768 elements) about 1e-4
off, relative, and the plain flash forward of the ``plain`` case of
``tests/test_torch_attention_kernels.py`` (its first attention call, shape
(4, 256, 256, 64)) then missed that file's 2e-5 bound. The port's plain
versions warm the exp once per process before their first call
(``ops/cpu_exp.warm``, which ``Environment.init`` on the CPU runs too).

Eight fresh processes at once -- the fault showed more often under load --
each run that case's plain forward as its first torch work (the tests' two
threads) and hold it to float64 softmax attention computed with numpy, at
the attention tests' TOL (2e-5 absolute and relative). Every one must pass.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PROCS = 8
TOL = dict(atol=2e-5, rtol=2e-5)

CHILD = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from mlsl_tpu_torch.ops import attention_kernels as tak
bh, sq, sk, d = 4, 256, 256, 64
rng = np.random.default_rng(sum(map(ord, "plain")))
mk = lambda s: rng.normal(size=(bh, s, d)).astype(np.float32)
q, k, v = mk(sq), mk(sk), mk(sk)
out, lse = tak.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), 0, 0, causal=False)
s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(d)
m = s.max(-1, keepdims=True)
p = np.exp(s - m)
want = p @ v.astype(np.float64) / p.sum(-1, keepdims=True)
want_lse = (m[..., 0] + np.log(p.sum(-1)))
json.dump({"out": out.numpy().tolist(), "lse": lse.numpy().tolist(),
           "want": want.tolist(), "want_lse": want_lse.tolist()}, sys.stdout)
"""


def test_plain_flash_fwd_first_call_in_fresh_processes():
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(PROCS)]
    results = [p.communicate(timeout=300) for p in procs]
    for i, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, err[-2000:]
        r = json.loads(out)
        np.testing.assert_allclose(np.asarray(r["out"]), np.asarray(r["want"]), **TOL,
                                   err_msg=f"process {i}")
        np.testing.assert_allclose(np.asarray(r["lse"]), np.asarray(r["want_lse"]), **TOL,
                                   err_msg=f"process {i}")
