"""Collective-op logging (counterpart of ``deepspeed_tpu/comm/logger.py``).

Parity target: ``deepspeed/utils/comms_logging.py`` — ``CommsLogger`` (:67) and the
``timed_op`` decorator (``deepspeed/comm/comm.py:106``). Each record is an op name,
its message size and, for an eagerly timed op, its latency, which is what the busbw
accounting needs. ``log_summary()`` mirrors ``dist.log_summary``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import log_dist


def _human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PB"


class CommsLogger:
    """Records (count, total bytes, eager latencies) per collective op name."""

    def __init__(self, enabled: bool = False, verbose: bool = False,
                 prof_all: bool = True, prof_ops: Optional[List[str]] = None,
                 debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.debug = debug
        self.comms_dict: Dict[str, Dict[int, List[float]]] = defaultdict(lambda: defaultdict(list))
        self.counts: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, float] = defaultdict(float)
        # registry-export high-water marks (comm/<op>_bytes|_calls counters)
        self._exported_calls: Dict[str, int] = {}
        self._exported_bytes: Dict[str, float] = {}
        # running sum: total_latency_s() is read once per training step, so
        # it must be O(1), not a re-sum of every latency ever recorded
        self._total_latency_s = 0.0

    def configure(self, config) -> None:
        self.enabled = config.enabled
        self.verbose = config.verbose
        self.prof_all = config.prof_all
        self.prof_ops = list(config.prof_ops)
        self.debug = config.debug

    def should_log(self, op_name: str) -> bool:
        return self.enabled and (self.prof_all or op_name in self.prof_ops)

    def append(self, op_name: str, msg_bytes: int, latency_s: Optional[float] = None,
               log_name: Optional[str] = None) -> None:
        if not self.should_log(op_name):
            return
        self.counts[op_name] += 1
        self.bytes[op_name] += msg_bytes
        if latency_s is not None:
            self.comms_dict[op_name][msg_bytes].append(latency_s)
            self._total_latency_s += latency_s
        if self.verbose:
            extra = f" lat={latency_s * 1e3:.3f}ms" if latency_s is not None else ""
            log_dist(f"comm: {log_name or op_name} size={_human_bytes(msg_bytes)}{extra}")

    def total_latency_s(self) -> float:
        """Running sum of every eagerly-timed collective latency (the
        engine differentiates this across step boundaries for the
        ``train/comm_ms`` gauge; traced ops contribute no latency). O(1):
        this is read on the training hot path every step."""
        return self._total_latency_s

    def export_to_registry(self, registry=None) -> None:
        """Emit per-op totals into the metrics registry as
        ``comm/<op>_bytes`` and ``comm/<op>_calls`` counters, so comms
        volume shows up on ``/metrics`` rather than only in log lines.
        Delta-tracked: safe to call repeatedly (every ``log_summary``)."""
        from deepspeed_tpu_torch.observability import get_registry

        reg = registry if registry is not None else get_registry()
        for op, count in self.counts.items():
            key = op.replace("/", "_")
            d_calls = count - self._exported_calls.get(op, 0)
            if d_calls > 0:
                reg.counter(f"comm/{key}_calls",
                            "collective invocations").inc(d_calls)
                self._exported_calls[op] = count
            d_bytes = self.bytes[op] - self._exported_bytes.get(op, 0.0)
            if d_bytes > 0:
                reg.counter(f"comm/{key}_bytes",
                            "collective payload bytes").inc(d_bytes)
                self._exported_bytes[op] = self.bytes[op]

    def log_summary(self, show_straggler: bool = False) -> str:
        lines = ["Comm. Op            Count      Total Size     Avg Latency"]
        for op, count in sorted(self.counts.items()):
            total = self.bytes[op]
            lats = [v for sizes in self.comms_dict[op].values() for v in sizes]
            avg_lat = (sum(lats) / len(lats) * 1e3) if lats else float("nan")
            lat_s = f"{avg_lat:10.3f} ms" if lats else "   (traced)"
            lines.append(f"{op:<20}{count:<11}{_human_bytes(total):<15}{lat_s}")
        out = "\n".join(lines)
        log_dist(out)
        self.export_to_registry()
        return out

    def reset(self) -> None:
        self.comms_dict.clear()
        self.counts.clear()
        self.bytes.clear()
        self._exported_calls.clear()
        self._exported_bytes.clear()
        self._total_latency_s = 0.0


# module-level singleton, mirroring the reference's global comms logger
comms_logger = CommsLogger()


class timed_op:
    """Context manager timing an eager collective and appending to the logger."""

    def __init__(self, name: str, msg_bytes: int):
        self.name = name
        self.msg_bytes = msg_bytes
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        comms_logger.append(self.name, self.msg_bytes, time.perf_counter() - self.t0)
        return False
