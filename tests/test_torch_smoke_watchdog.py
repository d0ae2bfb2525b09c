# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""``chip_smoke.py``'s run budget on the CPU: the watchdog fails a run
that outlasts its limit with the running phase's number, kills the
run's child processes and exits 1; each phase prints its budget."""

import os
import subprocess
import sys
import textwrap
import time

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A run whose phase 15 sleeps past a 1.5 s watchdog, with a child process
# that would sleep for a minute.
SLEEPING_RUN = textwrap.dedent("""
    import multiprocessing
    import sys
    import time

    sys.path.insert(0, {repo!r})
    import chip_smoke


    def nap():
        time.sleep(60)


    if __name__ == "__main__":
        child = multiprocessing.get_context("spawn").Process(target=nap)
        child.start()
        print(child.pid, flush=True)
        chip_smoke.start_watchdog(1.5)
        chip_smoke._phase_begin(15)
        time.sleep(60)
        print("not stopped", flush=True)
""")


def _gone(pid, timeout_s=10.0):
    """Whether process ``pid`` has exited (or is a zombie) within the
    deadline."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(")")[-1].split()[0] in ("Z", "X"):
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.05)
    return False


def test_watchdog_fails_the_run_naming_the_running_phase(tmp_path):
    script = tmp_path / "sleeping_run.py"
    script.write_text(SLEEPING_RUN.format(repo=REPO))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=60, cwd=str(tmp_path))
    wall = time.monotonic() - t0
    assert out.returncode == 1, (out.returncode, out.stdout, out.stderr)
    assert ("chip_smoke: FAILED: phase 15 still running after 1.5 s"
            in out.stderr), out.stderr
    assert "not stopped" not in out.stdout
    assert wall < 30, wall
    child = int(out.stdout.split()[0])
    assert _gone(child), f"the run's child {child} outlived the watchdog"


def test_watchdog_stops_quietly_when_the_run_ends(capsys):
    done = chip_smoke.start_watchdog(0.3)
    done.set()
    time.sleep(0.6)
    assert "FAILED" not in capsys.readouterr().err


def test_phase_wall_prints_the_phase_budget(capsys):
    t = chip_smoke._phase_begin(15)
    assert chip_smoke._running["phase"] == 15
    chip_smoke._phase_wall(15, t, "card")
    line = capsys.readouterr().out
    assert line.startswith("[phase 15] ")
    assert f"(budget {chip_smoke.PHASE_BUDGET_S[15]} s) on card" in line
    chip_smoke._phase_wall(15, t - 1e4, "card")
    assert "OVER BUDGET" in capsys.readouterr().out


def test_the_budget_fits_the_run():
    """The phases' budgets sum to at most 600 s, phase 15's to at most
    60 s, under the watchdog's limit."""
    total = sum(chip_smoke.PHASE_BUDGET_S.values())
    assert total <= 600, total
    assert chip_smoke.PHASE_BUDGET_S[15] <= 60
    assert total < chip_smoke.WATCHDOG_S


def test_every_join_deadline_is_at_most_240_s():
    for name in ("FED_JOIN_TIMEOUT_S", "SERVE_FED_TIMEOUT_S",
                 "ASYNC_TIMEOUT_S", "FAMILY_LORA_TIMEOUT_S",
                 "PRIVACY_TIMEOUT_S", "DMA_TIMEOUT_S", "OPS_JOIN_TIMEOUT_S",
                 "MULTIPROC_TIMEOUT_S"):
        assert getattr(chip_smoke, name) <= 240, name
