"""What the harness reads of the program's processes from /proc, and the
/dev/shm files they leave behind."""

from __future__ import annotations

import os
import subprocess

SHM = "/dev/shm"
TICK_S = 1.0 / os.sysconf("SC_CLK_TCK")
#: how often a run looks for the program's processes
LOOK_S = 1.0


def _stat(pid: str) -> tuple[int, float] | None:
    """(parent pid, user + system CPU seconds) of a process."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as stream:
            text = stream.read()
    except OSError:
        return None
    fields = text[text.rindex(b")") + 2:].split()
    return int(fields[1]), (int(fields[11]) + int(fields[12])) * TICK_S


def tree_cpu(root: int) -> tuple[float, set[int]]:
    """CPU seconds (user + system) of `root` and every live descendant,
    and their pids."""
    stats = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            stat = _stat(entry)
            if stat is not None:
                stats[int(entry)] = stat
    children: dict[int, list[int]] = {}
    for pid, (parent, _) in stats.items():
        children.setdefault(parent, []).append(pid)
    seen, todo, total = set(), [root], 0.0
    while todo:
        pid = todo.pop()
        if pid in seen or pid not in stats:
            continue
        seen.add(pid)
        total += stats[pid][1]
        todo.extend(children.get(pid, ()))
    return total, seen


def shm_left(pids: set[int]) -> list[str]:
    """/dev/shm entries named for one of `pids`, the program's processes
    (its segments are ``pheniqs-<pid>-...``); other runs' entries are not
    this run's to count."""
    try:
        names = os.listdir(SHM)
    except OSError:
        return []
    mine = {str(pid) for pid in pids}
    return sorted(name for name in names
                  if name.startswith("pheniqs-") and name.split("-")[1] in mine)


def kernels_built(root: str) -> bool:
    """Whether the program's kernel library is built in the checkout (a
    run that finds none builds it, in its set-up)."""
    build = os.path.join(root, "pheniqs_tpu_torch", "_build")
    return os.path.isdir(build) and any(n.endswith(".so") and "kernels" in n for n in os.listdir(build))


def device_memory_bytes() -> int | None:
    """Memory in use on card 0 by nvidia-smi, or None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return int(float(out.stdout.strip().splitlines()[0])) << 20
    except (ValueError, IndexError):
        return None


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
