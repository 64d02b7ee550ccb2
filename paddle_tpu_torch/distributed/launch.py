"""Multi-process launcher: ``python -m paddle_tpu_torch.distributed.launch``
(counterpart ``paddle_tpu/distributed/launch.py``; reference
``python/paddle/distributed/launch.py``).

One child per rank, each told who it is through the environment:
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_DIST_COORDINATOR`` (the ``tcp://`` rendezvous of
``fluid.distributed.init``) and ``PADDLE_LOCAL_DEVICE_IDS`` (its card:
``--selected_devices 0,1`` puts rank 0 on card 0 and rank 1 on card 1;
``0,0`` puts both on card 0, which only the gloo backend allows).
Without ``--selected_devices``, rank r of ``--nproc_per_node`` gets card
r.  With ``--log_dir`` each rank writes ``workerlog.<rank>``.

Supervision: every child leads its own session (process group), so a
teardown reaches the processes it forked.  When one child exits nonzero
the whole pack is torn down: SIGTERM to every group, SIGKILL after
``--grace_period`` seconds, and the launcher exits with that child's
code.  A SIGTERM or SIGINT to the launcher is forwarded the same way
(trainers with ``fluid.preemption.install()`` drain and exit 0).

Liveness (``--heartbeat_timeout S``): each child's armed watchdog
(``fluid.watchdog``) touches the file ``PADDLE_HEARTBEAT_FILE`` names; a
rank whose file goes stale for S seconds is SIGKILLed and handled as a
crash.  A rank whose own watchdog aborts exits with code 117
(``HANG_EXIT_CODE``), and the post-mortem line names it as hung.

Restarts (``--max_restarts N``): when a rank exits nonzero and the
budget allows, the whole pack is torn down (as above) and launched again
at a fresh rendezvous port (the ``--coordinator`` port plus the attempt
number): a ``torch.distributed`` world cannot take back a member that
died, and a straggler of the old world must never join the new one.
With ``--elastic_min_nproc M`` each relaunch shrinks the world by ONE
rank, never below M (exit codes cannot tell a rank that failed from one
that a collective's abort took down with it, so a larger loss converges
over successive relaunches); the fresh ranks reshard-restore the last
checkpoint (``fluid.elastic``).  Relaunched ranks see
``PADDLE_ELASTIC_ATTEMPT`` (relaunches so far) and
``PADDLE_ELASTIC_PREV_NPROC`` (the previous world's size); every restart
is logged on the launcher's stderr.  This module imports no torch.
"""

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

# paddle_tpu_torch.fluid.watchdog.EXIT_HANG, mirrored: the supervisor
# stays importable without torch
HANG_EXIT_CODE = 117


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch multi-process launcher")
    p.add_argument("--cluster_node_ips", default="127.0.0.1")
    p.add_argument("--node_ip", default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="processes per node (default 1)")
    p.add_argument("--selected_devices", default=None,
                   help="comma list of card ids, one per rank (repeats "
                        "allowed: 0,0 puts two ranks on card 0); "
                        "overrides --nproc_per_node")
    p.add_argument("--coordinator", default=None,
                   help="ip:port of the tcp:// rendezvous (default: the "
                        "first node's ip at --started_port + 1017)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--grace_period", type=float, default=30.0,
                   help="seconds between forwarding SIGTERM to the child "
                        "process groups and escalating to SIGKILL")
    p.add_argument("--heartbeat_timeout", type=float, default=0.0,
                   help="kill a rank whose PADDLE_HEARTBEAT_FILE (touched "
                        "by its armed watchdog) is stale this many "
                        "seconds, and tear down the pack; 0 = off")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch the pack at a fresh rendezvous port when "
                        "a rank exits nonzero, up to this many times "
                        "(default 0: fail fast)")
    p.add_argument("--elastic_min_nproc", type=int, default=None,
                   help="with --max_restarts: relaunch a crashed pack one "
                        "rank SMALLER, never below this floor (the ranks "
                        "reshard-restore the last checkpoint)")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.max_restarts < 0:
        p.error("--max_restarts must be >= 0")
    if args.elastic_min_nproc is not None and args.elastic_min_nproc < 1:
        p.error("--elastic_min_nproc must be >= 1: a floor of 0 would "
                "let successive relaunches shrink the job to no rank and "
                "report success")
    if args.elastic_min_nproc is not None and args.max_restarts < 1:
        p.error("--elastic_min_nproc needs --max_restarts >= 1: without a "
                "restart budget a crash fails fast and no relaunch at a "
                "smaller world ever happens")
    n_nodes = len([ip for ip in args.cluster_node_ips.split(",")
                   if ip.strip()])
    if args.max_restarts > 0 and n_nodes > 1:
        p.error("--max_restarts is single-node only: each node's launcher "
                "would decide the relaunch (and its rendezvous port) on "
                "its own")
    if args.heartbeat_timeout < 0:
        p.error("--heartbeat_timeout must be >= 0")
    return args


class _LauncherStop(Exception):
    """Raised out of the supervision loop when the launcher itself is
    told to stop."""


def _signal_pack(procs, sig):
    """``sig`` to every child's process group (a child is a session
    leader, so its pgid is its pid; signalling that directly also
    reaches a group whose leader already exited)."""
    for proc, _log, _rank in procs:
        try:
            os.killpg(proc.pid, sig)
        except (OSError, ProcessLookupError):
            try:
                proc.send_signal(sig)
            except (OSError, ProcessLookupError):
                pass


def _log(msg):
    sys.stderr.write("[launch] %s\n" % msg)
    sys.stderr.flush()


def terminate_pack(procs, grace_period, hung=None):
    """SIGTERM every child group, wait up to ``grace_period`` seconds,
    SIGKILL what is left, reap everything and close the logs.  With
    ``hung`` ({rank: heartbeat age}) a post-mortem line tells hung ranks
    (stale heartbeat, or the watchdog's exit 117) from crashed ones."""
    _signal_pack(procs, signal.SIGTERM)
    deadline = time.monotonic() + grace_period
    pending = list(procs)
    while pending and time.monotonic() < deadline:
        pending = [t for t in pending if t[0].poll() is None]
        if pending:
            time.sleep(0.05)
    if pending:
        _signal_pack(pending, signal.SIGKILL)
    for proc, log, _rank in procs:
        proc.wait()
        if log:
            log.close()
    if hung is not None and (hung or any(
            t[0].returncode not in (0, -signal.SIGTERM, -signal.SIGKILL)
            for t in procs)):
        parts = []
        for proc, _l, rank in sorted(procs, key=lambda t: t[2]):
            ret = proc.returncode
            if rank in hung:
                parts.append("rank %d HUNG (heartbeat stale %.1fs, "
                             "killed)" % (rank, hung[rank]))
            elif ret == HANG_EXIT_CODE:
                parts.append("rank %d HUNG (watchdog self-abort, exit %d)"
                             % (rank, ret))
            elif ret not in (0, -signal.SIGTERM, -signal.SIGKILL):
                parts.append("rank %d crashed (exit %d)" % (rank, ret))
            else:
                parts.append("rank %d ok/teardown (exit %s)" % (rank, ret))
        _log("post-mortem: " + "; ".join(parts))


def get_cluster_endpoints(args, nproc):
    ips = [ip.strip() for ip in args.cluster_node_ips.split(",")
           if ip.strip()]
    eps = ["%s:%d" % (ip, args.started_port + i)
           for ip in ips for i in range(nproc)]
    return ips, eps


def _supervise(args, nproc, devices, stop_seen, attempt=0, prev_nproc=None,
               restarts=None):
    """Spawn one incarnation of the pack and supervise it to its end.
    Returns the exit code, or ``(rank, code, failed ranks)`` when a rank
    failed and the restart budget (``restarts["used"]`` of
    ``--max_restarts``) allows a relaunch, which the caller makes."""
    restarts = restarts if restarts is not None else {"used": 0}
    ips, cluster_eps = get_cluster_endpoints(args, nproc)
    node_rank = ips.index(args.node_ip)
    coordinator = args.coordinator or \
        "%s:%d" % (ips[0], args.started_port + 1017)
    if attempt:
        # a fresh port for every relaunch: the old rendezvous socket may
        # linger, and no straggler of the old world may join the new one
        host, port = coordinator.rsplit(":", 1)
        coordinator = "%s:%d" % (host, int(port) + attempt)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    hb_dir = None
    if args.heartbeat_timeout > 0:
        hb_dir = args.log_dir or tempfile.mkdtemp(prefix="paddle_hb_")

    def hb_path(rank):
        return os.path.join(hb_dir, "heartbeat.%d" % rank)

    def spawn(local_rank):
        rank = node_rank * nproc + local_rank
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": cluster_eps[rank],
            "PADDLE_TRAINERS_NUM": str(len(cluster_eps)),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(cluster_eps),
            "PADDLE_DIST_COORDINATOR": coordinator,
            "PADDLE_LOCAL_DEVICE_IDS": devices[local_rank],
            "FLAGS_selected_gpus": devices[local_rank],
            "PADDLE_ELASTIC_ATTEMPT": str(attempt),
        })
        if prev_nproc is not None:
            env["PADDLE_ELASTIC_PREV_NPROC"] = str(prev_nproc)
        if hb_dir is not None:
            try:
                os.unlink(hb_path(rank))
            except OSError:
                pass
            env["PADDLE_HEARTBEAT_FILE"] = hb_path(rank)
        cmd = [sys.executable, "-u", args.training_script] + \
            args.training_script_args
        log = open(os.path.join(args.log_dir, "workerlog.%d" % rank),
                   "a" if attempt else "w") if args.log_dir else None
        return (subprocess.Popen(cmd, env=env, stdout=log,
                                 stderr=subprocess.STDOUT if log else None,
                                 start_new_session=True), log, rank)

    procs, done, hung = [], [], {}
    fail_rank, code = None, 0
    try:
        for local_rank in range(nproc):
            if stop_seen:
                raise _LauncherStop(stop_seen[0])
            procs.append(spawn(local_rank))
        while procs:
            if stop_seen:
                raise _LauncherStop(stop_seen[0])
            if hb_dir is not None:
                now = time.time()
                for proc, _l, rank in procs:
                    if rank in hung:
                        continue
                    try:
                        age = now - os.path.getmtime(hb_path(rank))
                    except OSError:
                        continue   # its watchdog never armed
                    if age > args.heartbeat_timeout:
                        hung[rank] = age
                        _log("rank %d heartbeat stale (%.1fs > %.1fs): "
                             "killing its process group"
                             % (rank, age, args.heartbeat_timeout))
                        try:
                            os.killpg(proc.pid, signal.SIGKILL)
                        except (OSError, ProcessLookupError):
                            pass
            for tup in list(procs):
                ret = tup[0].poll()
                if ret is None:
                    continue
                procs.remove(tup)
                done.append(tup)
                if tup[1]:
                    tup[1].close()
                if ret != 0:
                    fail_rank, code = tup[2], ret
                    raise ChildProcessError()
            time.sleep(0.1)
    except (ChildProcessError, KeyboardInterrupt, _LauncherStop) as e:
        # ranks already dead nonzero before the teardown failed on their
        # own; those that exit nonzero after its SIGTERM are victims of
        # the same failure and do not count
        failed = {r for p, _l, r in procs + done if p.poll() is not None
                  and p.returncode not in (0, -signal.SIGTERM,
                                           -signal.SIGKILL)}
        failed.update(hung)
        if fail_rank is not None:
            failed.add(fail_rank)
        terminate_pack(procs + done, args.grace_period, hung=hung)
        stopped = isinstance(e, _LauncherStop) or bool(stop_seen)
        if fail_rank is not None:
            if not stopped and restarts["used"] < args.max_restarts:
                restarts["used"] += 1
                return fail_rank, code, failed
            sys.stderr.write("rank %d failed with exit code %d; pack "
                             "terminated\n" % (fail_rank, code))
            return code if code > 0 else 1
        if stopped:
            # a drain: children that exited 0 after their final save
            # (or died of the forwarded SIGTERM) make the job clean
            bad = sorted(r for p, _l, r in procs + done
                         if p.returncode not in (0, -signal.SIGTERM))
            if bad:
                sys.stderr.write("stopped; rank(s) %s exited non-zero\n"
                                 % (bad,))
                return 1
            return 0
        raise
    except BaseException:
        terminate_pack(procs + done, args.grace_period)
        raise
    return 0


def launch(args):
    if args.selected_devices:
        devices = [d.strip() for d in args.selected_devices.split(",")
                   if d.strip()]
        nproc = len(devices)
    else:
        nproc = args.nproc_per_node or 1
        devices = [str(i) for i in range(nproc)]
    stop_seen = []

    def on_stop(signum, frame):
        # flag only: the supervision loop acts on it at a safe point
        if not stop_seen:
            stop_seen.append(signal.Signals(signum).name)

    if args.elastic_min_nproc is not None and \
            args.elastic_min_nproc > nproc:
        # a floor above the launched world would GROW the pack
        sys.stderr.write("--elastic_min_nproc %d exceeds the launched "
                         "world size %d\n" % (args.elastic_min_nproc, nproc))
        return 2
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, on_stop)
        except ValueError:
            pass   # not the main thread
    restarts = {"used": 0}
    attempt, prev_nproc = 0, None
    try:
        while True:
            out = _supervise(args, nproc, devices, stop_seen, attempt,
                             prev_nproc, restarts)
            if not isinstance(out, tuple):
                return out
            fail_rank, code, failed = out
            attempt += 1
            new_nproc = nproc
            if args.elastic_min_nproc is not None:
                new_nproc = max(int(args.elastic_min_nproc), nproc - 1)
            _log("rank %d exited %d (nonzero ranks %s); relaunching pack "
                 "(restart %d/%d, attempt %d, world %d -> %d)"
                 % (fail_rank, code, sorted(failed), restarts["used"],
                    args.max_restarts, attempt, nproc, new_nproc))
            prev_nproc, nproc = nproc, new_nproc
            devices = devices[:nproc]
            if stop_seen:
                # a stop between two incarnations: the crash stands
                sys.stderr.write("rank %d failed with exit code %d; stop "
                                 "requested — not relaunching\n"
                                 % (fail_rank, code))
                return code if code > 0 else 1
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def main():
    sys.exit(launch(parse_args()) or 0)


if __name__ == "__main__":
    main()
