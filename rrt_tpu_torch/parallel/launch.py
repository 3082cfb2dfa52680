"""Start the ranks of a sharded run on this host, a process each.

    from rrt_tpu_torch.parallel.launch import launch
    outs = launch(["rrt_tpu_torch.cli", "--scene", "chap12", "-o",
                   "mp.png"], 2, timeout=600)

Each rank runs `python -m <module> <args> --coordinator localhost:<a
free port> --num-processes N --process-id I`. The ranks share the
timeout; when it passes or any rank fails, every rank still running is
killed at once (a rank left waiting on a collective would otherwise
wait out the process group's timeout) and RuntimeError names the rank
and its output.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(module_args, n: int, *, timeout: float, env=None,
           cwd=None) -> list:
    """Run `python -m module_args...` as ranks 0..n-1 of one process
    group; returns each rank's combined stdout and stderr (text), in rank
    order, once all exit 0."""
    port = free_port()
    env = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{i}.log"), "w+")
                for i in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", *map(str, module_args), "--coordinator",
             f"localhost:{port}", "--num-processes", str(n),
             "--process-id", str(i)], env=env, cwd=cwd, stdout=log,
            stderr=subprocess.STDOUT, text=True)
            for i, log in enumerate(logs)]

        def output(i):
            logs[i].flush()
            logs[i].seek(0)
            return logs[i].read()

        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = [i for i, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {n} exited "
                        f"{procs[bad[0]].returncode}:\n{output(bad[0])}")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks ran past {timeout} s:\n"
                                       + output(0))
                time.sleep(0.1)
            for i, p in enumerate(procs):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {i} of {n} exited "
                                       f"{p.returncode}:\n{output(i)}")
            return [output(i) for i in range(n)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
