"""Typed in-process metric registry: the service's one accounting surface.

Port of `dorpatch_tpu.observe.metrics`, with the same metric names, label
keys, exposition bytes and snapshot JSON. One registry per service, three
metric types, and every reader (`/stats`, `GET /metrics`, `metrics.json`,
the load generator's reconciliation) renders from it:

- `Counter`   — monotonic, labeled (`serve_requests_total{status=ok}`);
  negative increments raise.
- `Gauge`     — last-write-wins value, or a *computed* gauge bound to a
  callable (`set_function`) so hot paths (batcher queue depth) pay no
  bookkeeping at all.
- `Histogram` — fixed cumulative buckets for the exposition PLUS a
  bounded raw-sample window so `percentile()` answers with the exact
  shared `nearest_rank_percentile` semantics every other surface
  (`/stats`, loadgen, the report CLI) already uses. The window is
  bounded the same way the serve latency ring was (trim half at 8192),
  so long-running services keep recent-window percentiles.

Snapshots: `snapshot()` is a plain-JSON dict; `dump()` writes it
atomically (tmp + `os.replace`) next to `events.jsonl` and NEVER raises —
a full disk leaves the previous snapshot intact, mirroring the EventLog's
ENOSPC degradation. `render_text()` is the Prometheus text exposition
served by `GET /metrics`; `parse_exposition()` is its inverse, used by
`tools/loadgen.py --expect-metrics` to reconcile client-side counts
against a live server without any dependency beyond stdlib.

Thread safety: one registry lock shared by every metric it owns — update
paths are a dict-get plus an add under that lock, and the 8-thread
concurrent-increment exactness test pins the contract.

Stdlib only by design: this module must import on the host-only surfaces
(the HTTP front-end, the load generator) without touching torch.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dorpatch_tpu_torch.observe.timing import nearest_rank_percentile

LabelKey = Tuple[Tuple[str, str], ...]

# Default histogram buckets: latency-in-ms oriented, 1ms..10s.
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0, 10000.0)

# Raw-sample window bound per histogram series — identical to the serve
# latency ring this module replaced: trim the oldest half at the cap so
# percentiles track the recent window without unbounded memory.
RAW_WINDOW = 8192
RAW_TRIM = 4096


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integral floats render without the
    trailing `.0` so counter lines read as the integers they are."""
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()
                   ) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + inner + "}"


class _Metric:
    """Base: name + help + the registry's shared lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock


class Counter(_Metric):
    """Monotonic labeled counter. `inc()` with a negative amount raises —
    a counter that can go down is a gauge wearing the wrong type."""

    kind = "counter"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        super().__init__(name, help, lock)
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        amt = float(amount)
        if amt < 0:
            raise ValueError(
                f"counter {self.name}: negative increment {amount!r}")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amt

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def series(self) -> List[dict]:
        with self._lock:
            items = sorted(self._series.items())
        return [{"labels": dict(k), "value": v} for k, v in items]

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._series.items())
        return [f"{self.name}{_render_labels(k)} {_fmt_value(v)}"
                for k, v in items]


class Gauge(_Metric):
    """Last-write-wins value per label set; `set_function` binds a series
    to a callable evaluated at read time (computed gauges cost their
    producer nothing on the hot path)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        super().__init__(name, help, lock)
        self._series: Dict[LabelKey, float] = {}
        self._functions: Dict[LabelKey, Callable[[], float]] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        with self._lock:
            self._functions[_label_key(labels)] = fn

    def _eval(self, key: LabelKey) -> Optional[float]:
        fn = self._functions.get(key)
        if fn is None:
            return None
        try:
            return float(fn())
        except Exception:
            return None  # a dead producer must not kill the exposition

    def value(self, **labels) -> float:
        key = _label_key(labels)
        computed = self._eval(key)
        if computed is not None:
            return computed
        with self._lock:
            return self._series.get(key, 0.0)

    def series(self) -> List[dict]:
        with self._lock:
            keys = sorted(set(self._series) | set(self._functions))
        out = []
        for key in keys:
            computed = self._eval(key)
            if computed is None:
                with self._lock:
                    computed = self._series.get(key, 0.0)
            out.append({"labels": dict(key), "value": computed})
        return out

    def render(self) -> List[str]:
        return [f"{self.name}{_render_labels(_label_key(s['labels']))} "
                f"{_fmt_value(s['value'])}" for s in self.series()]


class _HistSeries:
    __slots__ = ("bucket_counts", "count", "sum", "raw")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.raw: List[float] = []


class Histogram(_Metric):
    """Fixed-bucket histogram + bounded exact-percentile window."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, lock)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: empty bucket list")
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    s.bucket_counts[i] += 1
                    break
            s.count += 1
            s.sum += v
            s.raw.append(v)
            if len(s.raw) >= RAW_WINDOW:
                del s.raw[:RAW_TRIM]

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Exact nearest-rank percentile over the bounded raw window —
        the SAME formula `/stats`, loadgen, and the report CLI use."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            vals = sorted(s.raw) if s is not None else []
        return nearest_rank_percentile(vals, q)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.count if s is not None else 0

    def sum_(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.sum if s is not None else 0.0

    def series(self) -> List[dict]:
        with self._lock:
            items = [(k, list(s.bucket_counts), s.count, s.sum)
                     for k, s in sorted(self._series.items())]
        out = []
        for key, counts, count, total in items:
            out.append({
                "labels": dict(key),
                "count": count,
                "sum": total,
                "buckets": {_fmt_value(b): c
                            for b, c in zip(self.buckets, counts)},
            })
        return out

    def render(self) -> List[str]:
        with self._lock:
            items = [(k, list(s.bucket_counts), s.count, s.sum)
                     for k, s in sorted(self._series.items())]
        lines = []
        for key, counts, count, total in items:
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_render_labels(key, [('le', _fmt_value(bound))])}"
                    f" {cum}")
            lines.append(
                f"{self.name}_bucket{_render_labels(key, [('le', '+Inf')])}"
                f" {count}")
            lines.append(f"{self.name}_sum{_render_labels(key)} "
                         f"{_fmt_value(total)}")
            lines.append(f"{self.name}_count{_render_labels(key)} {count}")
        return lines


class MetricRegistry:
    """All of one process's metrics; constructors are idempotent per name
    (asking again returns the same object, a kind clash raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: self._lock

    def _make(self, name: str, help: str, cls, **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            metric = cls(name, help, self._lock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._make(name, help, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._make(name, help, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._make(name, help, Histogram, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Counter/gauge series value (histograms: the series count)."""
        m = self.get(name)
        if m is None:
            return default
        if isinstance(m, Histogram):
            return float(m.count(**labels))
        return m.value(**labels)

    def percentile(self, name: str, q: float, **labels) -> Optional[float]:
        m = self.get(name)
        if isinstance(m, Histogram):
            return m.percentile(q, **labels)
        return None

    # ---------------- snapshots & exposition ----------------

    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, dict] = {}
        for m in sorted(metrics, key=lambda m: m.name):
            out[m.name] = {"type": m.kind, "help": m.help,
                           "series": m.series()}
        return {"version": 1, "metrics": out}

    def dump(self, path: str) -> bool:
        """Atomic snapshot write (tmp + `os.replace`); NEVER raises — on
        any failure the previous snapshot file is left intact and False
        is returned (the ENOSPC contract the chaos test pins)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            snap = self.snapshot()
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(snap, fh, sort_keys=True)
                fh.write("\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            return True
        except Exception:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    def render_text(self) -> str:
        """Prometheus text exposition (the `GET /metrics` body)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[str, Dict[LabelKey, float]]:
    """Inverse of `render_text` for the sample lines (comments skipped):
    ``{sample_name: {label_key: value}}``. Histogram component samples
    appear under their suffixed names (`x_bucket`, `x_sum`, `x_count`)."""
    out: Dict[str, Dict[LabelKey, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_raw, _, value_raw = rest.rpartition("} ")
            pairs = []
            for part in _split_labels(labels_raw):
                if "=" not in part:
                    continue
                k, v = part.split("=", 1)
                v = v.strip()
                if v.startswith('"') and v.endswith('"'):
                    v = v[1:-1]
                v = (v.replace("\\n", "\n").replace('\\"', '"')
                     .replace("\\\\", "\\"))
                pairs.append((k.strip(), v))
            key = tuple(sorted(pairs))
        else:
            parts = line.split()
            if len(parts) < 2:
                continue
            name, value_raw = parts[0], parts[1]
            key = ()
        try:
            value = float(value_raw.strip())
        except ValueError:
            continue
        out.setdefault(name.strip(), {})[key] = value
    return out


def _split_labels(raw: str) -> List[str]:
    """Split `a="x",b="y,z"` on commas outside quotes."""
    parts, buf, in_quotes, escaped = [], [], False, False
    for ch in raw:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if ch == "\\":
            buf.append(ch)
            escaped = True
            continue
        if ch == '"':
            in_quotes = not in_quotes
            buf.append(ch)
            continue
        if ch == "," and not in_quotes:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return parts


def labeled_values(snapshot: dict, name: str, label: str
                   ) -> Dict[str, float]:
    """``{label_value: value}`` for one counter/gauge in a `snapshot()`
    (or `dump`ed) dict — the fleet cross-check's join primitive."""
    metric = (snapshot or {}).get("metrics", {}).get(name)
    out: Dict[str, float] = {}
    if not isinstance(metric, dict):
        return out
    for s in metric.get("series", ()):
        labels = s.get("labels", {})
        if label in labels and "value" in s:
            key = str(labels[label])
            out[key] = out.get(key, 0.0) + float(s["value"])
    return out
