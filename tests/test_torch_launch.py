"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
and the identity side of ``fluid.distributed``, on the CPU.

Each test starts a small pack whose children are this file run as a
script (``worker <mode> <dir>``; they import no torch), and reads what
the children wrote: the ``PADDLE_*`` environment of each rank
(``--selected_devices 3,3`` gives both ranks card 3); the teardown of
the whole pack when one child exits nonzero, its forked grandchild
included; SIGTERM forwarded to every child, then SIGKILL after
``--grace_period``; a stale heartbeat file killing its rank; the hang
exit code 117 named in the post-mortem; the relaunch matrix of
``--max_restarts`` (tests/test_launch_relaunch_matrix.py: a crash within
the budget, one that spends it, a hang exit, a stale heartbeat — each
relaunching the whole pack at a fresh rendezvous port, the port's only
mode) and the shrink of ``--elastic_min_nproc``, with the launcher's
argument checks.  In this
process: ``fluid.distributed`` in a world of one, its argument checks,
and an NCCL init with no card raising instead of falling back to gloo.
No test here creates a process group.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from paddle_tpu_torch.distributed import launch

REPO = Path(__file__).resolve().parents[1]
ENV_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_DIST_COORDINATOR", "PADDLE_LOCAL_DEVICE_IDS",
            "PADDLE_HEARTBEAT_FILE")


def _wait_for(pred, timeout=20.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie still answers kill(0); read its state
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def worker(mode, out_dir):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    out = Path(out_dir)
    if mode == "env":
        (out / ("env%d.json" % rank)).write_text(json.dumps(
            {k: os.environ.get(k) for k in ENV_KEYS}))
        print("rank %d says hello" % rank)
        return 0
    if mode == "crash":
        if rank == 1:
            time.sleep(0.5)
            return 3
        child = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(120)"])
        (out / "pids.json").write_text(json.dumps(
            {"rank0": os.getpid(), "grandchild": child.pid}))
        time.sleep(120)
        return 0
    if mode in ("term", "stubborn"):
        def on_term(signum, frame):
            (out / ("term%d" % rank)).write_text("SIGTERM")
            if mode == "term":
                sys.exit(0)
        signal.signal(signal.SIGTERM, on_term)
        (out / ("ready%d" % rank)).write_text(str(os.getpid()))
        time.sleep(120)
        return 0
    if mode == "stale":
        Path(os.environ["PADDLE_HEARTBEAT_FILE"]).write_text("beat")
        time.sleep(120)
        return 0
    if mode == "hang":
        return launch.HANG_EXIT_CODE if rank == 0 else 0
    if mode.startswith("again_"):
        # one line per attempt of this rank: what the launcher told it
        with open(out / ("attempts%d" % rank), "a") as f:
            f.write(json.dumps({k: os.environ.get(k) for k in (
                "PADDLE_ELASTIC_ATTEMPT", "PADDLE_ELASTIC_PREV_NPROC",
                "PADDLE_TRAINERS_NUM", "PADDLE_DIST_COORDINATOR")}) + "\n")
        attempt = int(os.environ["PADDLE_ELASTIC_ATTEMPT"])
        world = int(os.environ["PADDLE_TRAINERS_NUM"])

        def other_ran():
            # the failing rank fails once the other rank has written its
            # line of this attempt (a teardown may not race it)
            p = out / ("attempts%d" % (1 - rank))
            return world == 1 or (p.exists() and len(
                p.read_text().splitlines()) > attempt)
        if mode == "again_crash" and rank == 1 and attempt < 2:
            _wait_for(other_ran, 60)
            return 7
        if mode == "again_hang" and rank == 0 and attempt == 0:
            _wait_for(other_ran, 60)
            return launch.HANG_EXIT_CODE
        if mode == "again_wedge" and rank == 0 and attempt == 0:
            Path(os.environ["PADDLE_HEARTBEAT_FILE"]).write_text("beat")
            time.sleep(120)
        return 0
    raise ValueError(mode)


def _cmd(mode, out_dir, *launcher_args, nproc=2):
    return [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
            "--nproc_per_node", str(nproc), "--log_dir",
            str(Path(out_dir) / "logs"), *launcher_args, __file__,
            "worker", mode, str(out_dir)]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _run(mode, out_dir, *launcher_args, timeout=60):
    return subprocess.run(_cmd(mode, out_dir, *launcher_args), env=_env(),
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=timeout)


def test_each_rank_gets_its_identity(tmp_path):
    proc = _run("env", tmp_path, "--selected_devices", "3,3",
                "--started_port", "7100", "--heartbeat_timeout", "30")
    assert proc.returncode == 0, proc.stderr
    envs = [json.loads((tmp_path / ("env%d.json" % r)).read_text())
            for r in range(2)]
    eps = "127.0.0.1:7100,127.0.0.1:7101"
    for r, e in enumerate(envs):
        assert e["PADDLE_TRAINER_ID"] == str(r)
        assert e["PADDLE_TRAINERS_NUM"] == "2"
        assert e["PADDLE_TRAINER_ENDPOINTS"] == eps
        assert e["PADDLE_CURRENT_ENDPOINT"] == eps.split(",")[r]
        assert e["PADDLE_DIST_COORDINATOR"] == "127.0.0.1:%d" % (7100 + 1017)
        assert e["PADDLE_LOCAL_DEVICE_IDS"] == "3"
        assert e["PADDLE_HEARTBEAT_FILE"].endswith("heartbeat.%d" % r)
        assert "rank %d says hello" % r in \
            (tmp_path / "logs" / ("workerlog.%d" % r)).read_text()


def test_nonzero_child_tears_down_the_pack(tmp_path):
    t0 = time.monotonic()
    proc = _run("crash", tmp_path, "--grace_period", "2")
    assert proc.returncode == 3
    assert time.monotonic() - t0 < 30
    assert "rank 1 crashed (exit 3)" in proc.stderr
    pids = json.loads((tmp_path / "pids.json").read_text())
    # rank 0 and the process it forked (its session) are gone
    assert _wait_for(lambda: not any(_alive(p) for p in pids.values()), 5)


@pytest.mark.parametrize("mode", ["term", "stubborn"])
def test_sigterm_is_forwarded_then_escalated(tmp_path, mode):
    p = subprocess.Popen(_cmd(mode, tmp_path, "--grace_period", "1"),
                         env=_env(), cwd=str(REPO), stderr=subprocess.PIPE,
                         text=True)
    try:
        assert _wait_for(lambda: all(
            (tmp_path / ("ready%d" % r)).exists() for r in range(2)))
        t0 = time.monotonic()
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
    for r in range(2):
        assert (tmp_path / ("term%d" % r)).read_text() == "SIGTERM"
        pid = int((tmp_path / ("ready%d" % r)).read_text())
        assert not _alive(pid)
    if mode == "term":
        assert rc == 0          # a drain: every rank exited 0
    else:
        # SIGKILLed after the grace period: not a clean drain
        assert rc == 1
        assert time.monotonic() - t0 >= 1.0


def test_stale_heartbeat_kills_its_rank(tmp_path):
    proc = _run("stale", tmp_path, "--heartbeat_timeout", "1",
                "--grace_period", "1")
    assert proc.returncode != 0
    assert "heartbeat stale" in proc.stderr
    assert "HUNG (heartbeat stale" in proc.stderr


def test_hang_exit_code_is_named_in_the_post_mortem(tmp_path):
    from paddle_tpu_torch.fluid import watchdog
    assert launch.HANG_EXIT_CODE == watchdog.EXIT_HANG == 117
    proc = _run("hang", tmp_path, "--grace_period", "1")
    assert proc.returncode == 117
    assert "rank 0 HUNG (watchdog self-abort, exit 117)" in proc.stderr


# (mode, launcher arguments, exit code, attempts of rank 0 and rank 1,
#  stderr lines, {stderr line: count})
RELAUNCH = [
    pytest.param("again_crash", ["--max_restarts", "3"], 0, (3, 3),
                 ["relaunching pack (restart 2/3, attempt 2, world 2 -> 2)"],
                 {"relaunching pack (restart": 2},
                 id="crash-within-budget-relaunches"),
    pytest.param("again_crash", ["--max_restarts", "1"], 7, (2, 2),
                 ["relaunching pack (restart 1/1",
                  "rank 1 failed with exit code 7"], {},
                 id="crash-exhausts-budget-caps"),
    pytest.param("again_hang", ["--max_restarts", "1"], 0, (2, 2),
                 ["rank 0 HUNG (watchdog self-abort, exit 117)",
                  "relaunching pack (restart 1/1"], {},
                 id="exit-hang-classified-and-relaunched"),
    pytest.param("again_wedge", ["--max_restarts", "1",
                                 "--heartbeat_timeout", "2"], 0, (2, 2),
                 ["heartbeat stale", "HUNG (heartbeat stale",
                  "relaunching pack (restart 1/1"], {},
                 id="heartbeat-stale-killed-and-relaunched"),
    pytest.param("again_crash", ["--max_restarts", "2",
                                 "--elastic_min_nproc", "1"], 0, (2, 1),
                 ["world 2 -> 1"], {"relaunching pack (restart": 1},
                 id="elastic-shrinks-by-one"),
]


@pytest.mark.parametrize("mode,argv,rc,attempts,lines,counts", RELAUNCH)
def test_relaunch_matrix(tmp_path, mode, argv, rc, attempts, lines,
                         counts):
    """tests/test_launch_relaunch_matrix.py's scenarios: the port
    relaunches the WHOLE pack (a torch world cannot take back a dead
    member), each time at the next rendezvous port, and tells the ranks
    the attempt and the previous world's size."""
    proc = _run(mode, tmp_path, "--grace_period", "1",
                "--coordinator", "127.0.0.1:7300", *argv, timeout=120)
    assert proc.returncode == rc, proc.stderr
    for line in lines:
        assert line in proc.stderr, (line, proc.stderr)
    for line, n in counts.items():
        assert proc.stderr.count(line) == n, proc.stderr
    seen = [[json.loads(x) for x in (tmp_path / ("attempts%d" % r))
             .read_text().splitlines()] for r in range(2)]
    assert tuple(len(s) for s in seen) == attempts
    for a, env in enumerate(seen[0]):
        assert env["PADDLE_ELASTIC_ATTEMPT"] == str(a)
        assert env["PADDLE_DIST_COORDINATOR"] == "127.0.0.1:%d" % (7300 + a)
    if mode == "again_crash" and "--elastic_min_nproc" in argv:
        assert [e["PADDLE_TRAINERS_NUM"] for e in seen[0]] == ["2", "1"]
        assert seen[0][1]["PADDLE_ELASTIC_PREV_NPROC"] == "2"
    else:
        assert seen[0][0]["PADDLE_ELASTIC_PREV_NPROC"] is None
        assert all(e["PADDLE_TRAINERS_NUM"] == "2" for e in seen[0])


@pytest.mark.parametrize("argv,why", [
    (["--elastic_min_nproc", "1"], "needs --max_restarts"),
    (["--max_restarts", "1", "--elastic_min_nproc", "0"], "must be >= 1"),
    (["--max_restarts", "-1"], "must be >= 0"),
    (["--max_restarts", "1", "--cluster_node_ips", "a,b"],
     "single-node only")])
def test_relaunch_arguments_are_checked(capsys, argv, why):
    with pytest.raises(SystemExit):
        launch.parse_args(argv + ["train.py"])
    assert why in capsys.readouterr().err


def test_elastic_floor_above_the_world_is_refused(capsys):
    args = launch.parse_args(["--nproc_per_node", "2", "--max_restarts",
                              "1", "--elastic_min_nproc", "3", "train.py"])
    assert launch.launch(args) == 2
    assert "exceeds the launched world size 2" in capsys.readouterr().err


def test_distributed_world_of_one(monkeypatch):
    from paddle_tpu_torch.fluid import distributed as dist
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert dist.init() == (0, 1)
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.is_chief() and dist.backend() is None
    assert dist.consensus_flags(True, False) == (True, False)
    assert dist.any_process(False) is False
    assert dist.all_processes_equal(5) == 5
    dist.barrier()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "10.0.0.1:6170,x:1")
    monkeypatch.setenv("PADDLE_LOCAL_DEVICE_IDS", "5,6")
    assert dist.parallel_env_from_env() == ("10.0.0.1:7187", 4, 2, [5, 6])
    assert dist.local_device_index() == 5


def test_distributed_init_checks_and_no_gloo_fallback(monkeypatch):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist, mesh_utils
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="no coordinator"):
        dist.init(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="backend"):
        dist.init("127.0.0.1:1", num_processes=2, process_id=0,
                  backend="mpi")
    assert mesh_utils.local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        # NCCL, the default, needs a card: it raises, it never retries
        # on gloo
        with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA"):
            dist.init("127.0.0.1:1", num_processes=2, process_id=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_utils.local_devices()
    assert not torch.distributed.is_initialized()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.exit(worker(sys.argv[2], sys.argv[3]))
