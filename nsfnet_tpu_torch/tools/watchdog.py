"""Unattended-training watchdog for the port (the protocol of
scripts/run_with_watchdog.sh, in Python): restarts the trainer from the
newest full-state checkpoint when its log goes stale (a hung dispatch, which
the in-process rollback cannot catch) or the process dies.

    python -m nsfnet_tpu_torch.tools.watchdog [--nproc N] [--torchrun] [--cpu] \\
        <config.yaml> <logfile> [stale_secs] [cold-start args...]

  * The trainer is `torchrun --standalone --nproc_per_node=N -m
    nsfnet_tpu_torch.train --config <config>` (`python -u -m
    nsfnet_tpu_torch.train` at one process unless `--torchrun`), its output
    appended to the log.
  * Cold-start args (e.g. `--init-from ckpt`) are passed only while no
    `*.ckpt` exists under the config's checkpoint_dir; after that every
    restart is `--resume <newest *.ckpt>`. A path in
    `<checkpoint_dir>/cold_init_override` replaces the one after
    `--init-from` in the cold args.
  * A log older than `stale_secs` (default 600): SIGTERM (train.py
    checkpoints and exits 3), SIGKILL after a 180 s grace, then a restart.
  * WATCHDOG_DEADLINE_TS=<epoch seconds>: at that time the trainer is
    stopped the same way and the watchdog exits 0 (resume later).
  * `.run/pause` (relative to the working directory): no launch while the
    flag exists; a flag older than WATCHDOG_PAUSE_MAX seconds (default 1800)
    is removed. The live trainer's PID is in `<logfile>.pid` and
    `.run/<config name>.pid` (removed on exit): kill by PID, never by pattern.
  * The trainer's exit 0 ends the watchdog with 0; exit 2 (a configuration
    error, which a restart would repeat) with 1; anything else restarts it.

`run()` takes the script's poll and grace intervals as keyword arguments.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

from nsfnet_tpu_torch.config import ConfigManager


def trainer_command(nproc: int = 1, torchrun: bool = False) -> list:
    """The trainer's launch line: torchrun (`python -m torch.distributed.run`)
    for several processes or where asked, else one Python process."""
    if nproc > 1 or torchrun:
        return [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={nproc}", "-m", "nsfnet_tpu_torch.train"]
    return [sys.executable, "-u", "-m", "nsfnet_tpu_torch.train"]


def newest_checkpoint(results_dir: str) -> Optional[str]:
    found = glob.glob(os.path.join(results_dir, "**", "*.ckpt"), recursive=True)
    return max(found, key=os.path.getmtime) if found else None


def _say(log: str, msg: str) -> None:
    with open(log, "a") as f:
        f.write(f"[watchdog] {msg}\n")


def _stop(proc: subprocess.Popen, log: str, grace: float, grace_poll: float) -> None:
    """SIGTERM, then SIGKILL if the trainer outlives `grace` seconds."""
    proc.send_signal(signal.SIGTERM)
    t_end = time.time() + grace
    while proc.poll() is None and time.time() < t_end:
        time.sleep(grace_poll)
    if proc.poll() is None:
        _say(log, f"trainer ignored SIGTERM for {grace:g}s - SIGKILL")
        proc.kill()
    proc.wait()


def run(config: str, log: str, stale: float = 600.0, cold_args: Sequence[str] = (),
        nproc: int = 1, torchrun: bool = False, trainer: Optional[Sequence[str]] = None,
        trainer_args: Sequence[str] = (), poll: float = 60.0, grace: float = 180.0,
        grace_poll: float = 5.0, pause_poll: float = 15.0, restart_delay: float = 10.0,
        kill_settle: float = 5.0, deadline: Optional[float] = None,
        pause_max: Optional[float] = None) -> int:
    """The watchdog loop; returns its exit code. `trainer` replaces the
    launch line (`trainer_command`); `trainer_args` go to every launch
    (e.g. `--cpu`). `deadline` and `pause_max` default to
    WATCHDOG_DEADLINE_TS (0: none) and WATCHDOG_PAUSE_MAX (1800)."""
    if deadline is None:
        deadline = float(os.environ.get("WATCHDOG_DEADLINE_TS", "0") or 0)
    if pause_max is None:
        pause_max = float(os.environ.get("WATCHDOG_PAUSE_MAX", "1800"))
    cfg = ConfigManager.from_file(config).config
    results_dir = cfg.training.checkpoint_dir
    cmd = list(trainer or trainer_command(nproc, torchrun))
    cold = list(cold_args)
    open(log, "a").close()
    run_reg = os.path.join(".run", os.path.splitext(os.path.basename(config))[0] + ".pid")
    pause_flag = os.path.join(".run", "pause")
    os.makedirs(".run", exist_ok=True)
    past_deadline = lambda: deadline > 0 and time.time() >= deadline

    override_file = os.path.join(results_dir, "cold_init_override")
    if os.path.isfile(override_file):
        with open(override_file) as f:
            override = f.readline().strip()
        if os.path.isfile(override):
            for i, a in enumerate(cold[:-1]):
                if a == "--init-from":
                    cold[i + 1] = override
                    _say(log, f"cold-start override: --init-from {override}")
        else:
            _say(log, f"cold_init_override points at missing file: {override} (ignored)")

    try:
        while True:
            while os.path.exists(pause_flag):
                if past_deadline():
                    _say(log, "deadline reached while paused - exiting")
                    return 0
                try:
                    age = time.time() - os.path.getmtime(pause_flag)
                except OSError:
                    break
                if age > pause_max:
                    _say(log, f"pause flag stale {age:.0f}s (bench crashed?) - removing "
                              f"and resuming")
                    os.remove(pause_flag)
                    break
                time.sleep(pause_poll)
            latest = newest_checkpoint(results_dir)
            extra = ["--resume", latest] if latest else cold
            _say(log, f"launching (resume: {latest or 'none'})")
            with open(log, "a") as out:
                proc = subprocess.Popen([*cmd, "--config", config, *extra, *trainer_args],
                                        stdout=out, stderr=subprocess.STDOUT)
            for path in (log + ".pid", run_reg):
                with open(path, "w") as f:
                    f.write(f"{proc.pid}\n")
            while proc.poll() is None:
                t_wait = time.time() + poll
                while proc.poll() is None and time.time() < t_wait:
                    time.sleep(min(1.0, poll))
                if proc.poll() is not None:
                    break
                if past_deadline():
                    # SIGTERM lets the trainer finish its chunk, checkpoint and
                    # exit; SIGKILL only if it ignores TERM for the grace
                    _say(log, f"deadline reached - SIGTERM pid {proc.pid} (resume later "
                              f"from newest ckpt)")
                    _stop(proc, log, grace, grace_poll)
                    return 0
                age = time.time() - os.path.getmtime(log)
                if age > stale:
                    _say(log, f"log stale {age:.0f}s - SIGTERM pid {proc.pid}")
                    _stop(proc, log, grace, grace_poll)
                    time.sleep(kill_settle)
                    break
            rc = proc.wait()
            if rc == 0:
                _say(log, "training completed")
                return 0
            if rc == 2:
                # argparse / config errors repeat on every restart: fail fast
                _say(log, "trainer exited with a configuration error (rc=2) - aborting")
                return 1
            _say(log, f"run ended abnormally (rc={rc}) - restarting")
            time.sleep(restart_delay)
    finally:
        if os.path.exists(run_reg):
            os.remove(run_reg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Restart nsfnet_tpu_torch.train from its newest checkpoint when it "
                    "hangs or dies")
    p.add_argument("--nproc", type=int, default=1,
                   help="processes (cards) per launch: torchrun above 1")
    p.add_argument("--torchrun", action="store_true",
                   help="launch under torchrun at one process too")
    p.add_argument("--cpu", action="store_true", help="pass --cpu to every launch")
    p.add_argument("config")
    p.add_argument("log")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="[stale_secs] [cold-start args...]")
    args = p.parse_args(argv)
    rest, stale = list(args.rest), 600.0
    if rest and rest[0].isdigit():
        stale = float(rest.pop(0))  # optional; cold args may follow directly
    return run(args.config, args.log, stale=stale, cold_args=rest, nproc=args.nproc,
               torchrun=args.torchrun, trainer_args=["--cpu"] if args.cpu else [])


if __name__ == "__main__":
    raise SystemExit(main())
