"""Metrics registry: named counters, gauges, and fixed-bucket histograms.

The port's own copy of the reference's ``repro.obs.metrics`` (pure Python;
the reference package's ``obs`` imports JAX for its profiler hooks).

One low-overhead telemetry surface shared by the serving engine and the
training loop, so throughput/SLO claims are measured the same way
everywhere instead of each subsystem growing its own ad-hoc dict of
counters.  Design constraints, in order:

  * **Hot-path cost is a Python attribute add.**  ``Counter.inc`` /
    ``Gauge.set`` / ``Histogram.observe`` touch plain host floats — no
    locks (the engine and trainer are single-threaded per process), no
    allocation after the first ``labels()`` resolution, and never a
    device sync.  Instrumentation must stay inside the engine's
    one-bulk-transfer-per-step contract and the trainer's
    one-transfer-per-log-interval contract; everything here consumes
    values the host already holds.
  * **Labels resolve once.**  ``family.labels(v)`` returns a child
    series; callers cache the child (the engine resolves its lifecycle
    counters at construction), so steady state never re-hashes label
    tuples.
  * **Two export formats.**  ``to_prometheus()`` writes the standard
    text exposition (``# HELP`` / ``# TYPE`` / samples, cumulative
    histogram buckets with ``+Inf``); ``dump_json()`` appends one
    timestamped record to a ``{"runs": [...]}`` trajectory file — the
    same shape as the repo's ``BENCH_*.json`` perf trajectories — with
    the tmp-file + ``os.replace`` atomicity of ``checkpoint/ckpt.py``.

Histograms are fixed-bucket (Prometheus-style): quantiles come from
linear interpolation inside the bucket that crosses the target rank, so
``quantile(0.99)`` is an estimate bounded by bucket width, not an exact
order statistic — good enough for TTFT/ITL/step-time SLO reporting and
O(len(buckets)) memory forever.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default latency buckets (seconds): log-spaced from 100us to 60s, the
# range TTFT / ITL / queue-wait / step-time land in on anything from a
# smoke CPU run to a loaded accelerator
LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers render bare, floats full."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    """Monotonically increasing value (one label-resolved series)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0 (got {n})")
        self.value += n


class Gauge:
    """Point-in-time value (one label-resolved series)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram (one label-resolved series).

    ``bucket_counts[i]`` counts observations <= ``buckets[i]`` exclusive
    of earlier buckets (non-cumulative internally; the exposition writer
    emits the cumulative Prometheus form).  The implicit final bucket
    catches everything above the last boundary."""

    __slots__ = ("buckets", "bucket_counts", "count", "sum")

    def __init__(self, buckets: Sequence[float]) -> None:
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be strictly increasing: {b}")
        self.buckets = b
        self.bucket_counts = [0] * (len(b) + 1)   # +1: the +Inf overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (Prometheus semantics).

        Returns 0.0 on an empty histogram.  Ranks landing in the +Inf
        overflow bucket clamp to the last finite boundary — the estimate
        is then a lower bound, which is the conservative direction for a
        latency SLO."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1] (got {q})")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, n in enumerate(self.bucket_counts):
            if seen + n >= rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                frac = (rank - seen) / n if n else 0.0
                return lo + (hi - lo) * frac
            seen += n
        return self.buckets[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric plus its label-resolved children.

    With no declared labels the family owns a single anonymous child and
    forwards ``inc``/``set``/``observe``/``value`` to it, so unlabeled
    metrics read naturally: ``reg.counter("steps").inc()``."""

    __slots__ = ("name", "help", "kind", "label_names", "children", "_mk")

    def __init__(self, name: str, help: str, kind: str,
                 label_names: Tuple[str, ...], mk) -> None:
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = label_names
        self.children: Dict[Tuple[str, ...], object] = {}
        self._mk = mk
        if not label_names:
            self.children[()] = mk()

    def labels(self, *values: str):
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {len(values)} values"
            )
        key = tuple(str(v) for v in values)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = self._mk()
        return child

    # unlabeled convenience forwarding
    def _solo(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                f"use .labels(...)"
            )
        return self.children[()]

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._solo().dec(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    @property
    def value(self) -> float:
        return self._solo().value

    def quantile(self, q: float) -> float:
        return self._solo().quantile(q)

    @property
    def mean(self) -> float:
        return self._solo().mean

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum


class MetricsRegistry:
    """Process-local registry of named metric families.

    Registration is idempotent: asking for an existing name returns the
    existing family (kind and labels must match), so two subsystems —
    or two Engine instances sharing one registry — aggregate into the
    same series instead of clobbering each other."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}

    def _register(self, name: str, help: str, kind: str,
                  labels: Sequence[str], mk) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.label_names}"
                )
            return fam
        fam = _Family(name, help, kind, tuple(labels), mk)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register(name, help, "counter", labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._register(name, help, "gauge", labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  labels: Sequence[str] = ()) -> _Family:
        return self._register(
            name, help, "histogram", labels, lambda: Histogram(buckets)
        )

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    # ------------------------------------------------------------- export
    def to_prometheus(self) -> str:
        """Standard Prometheus text exposition (version 0.0.4)."""
        out: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                out.append(f"# HELP {name} {_escape(fam.help)}")
            out.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.children):
                child = fam.children[key]
                pairs = list(zip(fam.label_names, key))
                lbl = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
                if fam.kind == "histogram":
                    cum = 0
                    for i, b in enumerate(child.buckets):
                        cum += child.bucket_counts[i]
                        le = (lbl + "," if lbl else "") + f'le="{_fmt(b)}"'
                        out.append(f"{name}_bucket{{{le}}} {cum}")
                    le = (lbl + "," if lbl else "") + 'le="+Inf"'
                    out.append(f"{name}_bucket{{{le}}} {child.count}")
                    sfx = f"{{{lbl}}}" if lbl else ""
                    out.append(f"{name}_sum{sfx} {_fmt(child.sum)}")
                    out.append(f"{name}_count{sfx} {child.count}")
                else:
                    sfx = f"{{{lbl}}}" if lbl else ""
                    out.append(f"{name}{sfx} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> List[dict]:
        """One JSON-able row per series (histograms carry quantiles)."""
        rows: List[dict] = []
        for name in sorted(self._families):
            fam = self._families[name]
            for key in sorted(fam.children):
                child = fam.children[key]
                full = name
                if key:
                    lbl = ",".join(
                        f'{k}="{v}"' for k, v in zip(fam.label_names, key)
                    )
                    full = f"{name}{{{lbl}}}"
                if fam.kind == "histogram":
                    rows.append({
                        "name": full, "kind": "histogram",
                        "count": child.count, "sum": child.sum,
                        "mean": child.mean,
                        "p50": child.quantile(0.50),
                        "p95": child.quantile(0.95),
                        "p99": child.quantile(0.99),
                    })
                else:
                    rows.append({
                        "name": full, "kind": fam.kind, "value": child.value,
                    })
        return rows

    def dump_json(self, path: str, *, now: Optional[float] = None,
                  extra: Optional[dict] = None) -> None:
        """Append one snapshot record to a ``{"runs": [...]}`` trajectory.

        Same file shape and atomic-write discipline as the repo's
        ``BENCH_*.json`` perf trajectories (``benchmarks/run.py``): each
        record is ``{"timestamp", "rows", ...extra}``, the whole file is
        rewritten to a tmp path and ``os.replace``d, so a reader never
        sees a torn snapshot.  ``now`` is injectable (epoch seconds) for
        deterministic tests."""
        stamp = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ",
            time.gmtime(time.time() if now is None else now),
        )
        try:
            with open(path) as f:
                runs = json.load(f)["runs"]
        except (OSError, ValueError, KeyError):
            runs = []
        rec = {"timestamp": stamp, "rows": self.snapshot()}
        if extra:
            rec.update(extra)
        runs.append(rec)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"runs": runs}, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)

    def write_prometheus(self, path: str) -> None:
        """Atomic exposition dump (tmp + ``os.replace``, like dump_json)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)
