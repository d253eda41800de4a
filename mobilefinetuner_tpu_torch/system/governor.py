"""Step-pacing governor: deterministic throttle / duty-cycle control for the
training loop (the port's own copy of mobilefinetuner_tpu/system/
governor.py: the same schedule grammar, policy, sysfs sensors and
`throttle` event; no GPU sensor, as the JAX governor has none).

The analog of the reference's energy-aware PowerMonitor
(reference: operators/opt_ops/energy/power_monitor.{h,cpp}): every
`check_interval_steps` steps, telemetry (battery %, temperature °C) maps to a
target step frequency, and the trainer sleeps `suggest_sleep_ms(step)` between
optimizer steps:

  f_batt = freq_batt_low  if battery < battery_threshold else freq_batt_high
  f_temp = freq_temp_low  if temp    > temp_threshold    else freq_temp_high
  f      = min(f_batt, f_temp);  sleep_ms = 1000 / f, clamped to 5000
  (power_monitor.cpp:72-96)

A deterministic override schedule string "0-99:300,100-199:150,200-:50"
(step-range -> sleep_ms) takes precedence over telemetry
(power_monitor.cpp:28-70). Telemetry can be injected manually for platforms
without sensors (power_monitor.h:47-48) — an accelerator host has no
battery, so manual injection / schedule mode is the normal use; the governor is a
duty-cycle knob for shared-host politeness and for reproducing the
reference's energy benchmarks (scripts/benchmark/test_energy_function.sh).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, List, Optional

MAX_SLEEP_MS = 5000.0  # clamp, power_monitor.cpp:92


@dataclasses.dataclass
class StepSleep:
    """One parsed schedule range: steps in [start, end] sleep `sleep_ms`.
    end=None means open-ended ("200-:50")."""
    start: int
    end: Optional[int]
    sleep_ms: float

    def covers(self, step: int) -> bool:
        return step >= self.start and (self.end is None or step <= self.end)


def parse_schedule(spec: str) -> List[StepSleep]:
    """Parse "0-99:300,100-199:150,200-:50" (power_monitor.cpp:28-70).

    Each entry is "<start>-<end>:<ms>" or "<start>-:<ms>" (open-ended).
    A bare "<step>:<ms>" pins a single step. Whitespace tolerated.
    """
    out: List[StepSleep] = []
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(\d+)\s*-\s*(\d*)\s*:\s*(\d+(?:\.\d+)?)", part)
        if m:
            start, end_s, ms = m.group(1), m.group(2), m.group(3)
            out.append(StepSleep(int(start),
                                 int(end_s) if end_s else None, float(ms)))
            continue
        m = re.fullmatch(r"(\d+)\s*:\s*(\d+(?:\.\d+)?)", part)
        if m:
            s = int(m.group(1))
            out.append(StepSleep(s, s, float(m.group(2))))
            continue
        raise ValueError(f"bad schedule entry: {part!r}")
    return out


@dataclasses.dataclass
class GovernorConfig:
    """Mirror of the reference PowerConfig (power_monitor.h:20-35)."""
    enable: bool = False
    check_interval_steps: int = 10    # <= 0 disables the telemetry policy
    battery_threshold: float = 20.0   # percent
    temp_threshold: float = 40.0      # celsius
    freq_batt_high: float = 10.0      # steps/sec when battery healthy
    freq_batt_low: float = 1.0        # steps/sec when battery low
    freq_temp_high: float = 10.0
    freq_temp_low: float = 0.5
    schedule: str = ""                # deterministic override
    manual_battery: Optional[float] = None
    manual_temp: Optional[float] = None


class StepGovernor:
    """suggest_sleep_ms(step) -> ms to sleep after this optimizer step.

    Telemetry readers default to the manual injections in the config; a real
    platform can pass `battery_fn` / `temp_fn` callables.

    `event_sink`: optional callable(dict); a throttle() that actually
    sleeps reports {step, sleep_ms, battery, temp, source} through it —
    the run-telemetry `throttle` event (core/telemetry.py), so duty-cycle
    decisions that silently stretch step time become visible in the
    event stream instead of looking like a slow device. Events fire on
    DECISION CHANGES (a different sleep_ms or source than the last
    emitted), not per sleeping step: a steady `--pm_schedule "0-:100"`
    run emits ONE event, not one per step — the event stream stays
    small (telemetry's own sizing rule), while the per-interval sleep
    TOTAL rides in step_stats.slept_ms.
    """

    def __init__(self, config: GovernorConfig,
                 battery_fn: Optional[Callable[[], float]] = None,
                 temp_fn: Optional[Callable[[], float]] = None,
                 event_sink: Optional[Callable[[dict], object]] = None):
        self.config = config
        self._schedule = parse_schedule(config.schedule)
        self._battery_fn = battery_fn
        self._temp_fn = temp_fn
        self._event_sink = event_sink
        self._cached_sleep_ms = 0.0
        self._last_check_step: Optional[int] = None
        # last SAMPLED sensor values (set by _telemetry_sleep_ms) — the
        # throttle event reports these instead of re-reading possibly
        # expensive sensor callables outside the check cadence
        self._last_battery: Optional[float] = None
        self._last_temp: Optional[float] = None
        self._last_emitted = None  # (sleep_ms, source) of the last event
        # run-total deliberate idleness, independently clocked from the
        # goodput meter's governor_sleep bucket; run_end carries it as
        # governor_slept_ms (cli/common.end_run) so a post-mortem can
        # cross-check the two (the per-flush slept_ms in step_stats is
        # interval-scoped and resets)
        self.total_slept_ms = 0.0

    # -- telemetry ----------------------------------------------------------
    def set_manual_telemetry(self, battery: Optional[float] = None,
                             temp: Optional[float] = None):
        """Manual injection (power_monitor.h:47-48)."""
        if battery is not None:
            self.config.manual_battery = battery
        if temp is not None:
            self.config.manual_temp = temp
        self._last_check_step = None  # force re-evaluation next step

    def _read_battery(self) -> Optional[float]:
        if self.config.manual_battery is not None:
            return self.config.manual_battery
        return self._battery_fn() if self._battery_fn else None

    def _read_temp(self) -> Optional[float]:
        if self.config.manual_temp is not None:
            return self.config.manual_temp
        return self._temp_fn() if self._temp_fn else None

    # -- policy -------------------------------------------------------------
    def _sensor_snapshot(self):
        """(battery, temp) for event payloads WITHOUT touching the sensor
        callables: manual injections are free to read; fn-backed sensors
        report their last sample from the check cadence (None before the
        first check) — the event must not defeat check_interval_steps'
        rate limiting."""
        batt = (self.config.manual_battery
                if self.config.manual_battery is not None
                else self._last_battery)
        temp = (self.config.manual_temp
                if self.config.manual_temp is not None
                else self._last_temp)
        return batt, temp

    def _telemetry_sleep_ms(self) -> float:
        c = self.config
        battery, temp = self._read_battery(), self._read_temp()
        self._last_battery, self._last_temp = battery, temp
        f_batt = (c.freq_batt_low if (battery is not None
                                      and battery < c.battery_threshold)
                  else c.freq_batt_high)
        f_temp = (c.freq_temp_low if (temp is not None
                                      and temp > c.temp_threshold)
                  else c.freq_temp_high)
        f = min(f_batt, f_temp)
        if f <= 0:
            return MAX_SLEEP_MS
        return min(1000.0 / f, MAX_SLEEP_MS)

    def suggest_sleep_ms(self, step: int) -> float:
        if not self.config.enable:
            return 0.0
        for rng in self._schedule:  # schedule overrides telemetry
            if rng.covers(step):
                return min(rng.sleep_ms, MAX_SLEEP_MS)
        # Uncovered steps fall through to the telemetry policy (the
        # reference PowerMonitor does the same, power_monitor.cpp
        # suggest_sleep_ms), so --pm_schedule composes with --pm_interval.
        # check_interval_steps <= 0 disables telemetry entirely, so a
        # schedule-only config runs uncovered steps at full speed.
        if self.config.check_interval_steps <= 0:
            return 0.0
        k = max(self.config.check_interval_steps, 1)
        if (self._last_check_step is None
                or step - self._last_check_step >= k):
            self._cached_sleep_ms = self._telemetry_sleep_ms()
            self._last_check_step = step
        return self._cached_sleep_ms

    def throttle(self, step: int):
        """Sleep per policy (trainer call site; gemma_trainer.cpp loop,
        gpt2_lora_finetune/main.cpp:679-683). A non-zero sleep whose
        DECISION differs from the last emitted one first reports it AND
        its inputs through event_sink, so the telemetry stream records
        why steps are being stretched without growing per-step."""
        ms = self.suggest_sleep_ms(step)
        if ms > 0:
            if self._event_sink is not None:
                src = ("schedule"
                       if any(r.covers(step) for r in self._schedule)
                       else "telemetry")
                if (ms, src) != self._last_emitted:
                    self._last_emitted = (ms, src)
                    batt, temp = self._sensor_snapshot()
                    self._event_sink({
                        "step": step, "sleep_ms": ms, "battery": batt,
                        "temp": temp, "source": src})
            self.total_slept_ms += ms
            time.sleep(ms / 1000.0)
        return ms
