"""Per-metric (step, value) history with best-value queries.

Parity with reference `metric_history.py:13-76`; copied from the JAX
package's `utils/metric_history.py` (numpy only).
"""

from __future__ import annotations

import numpy as np


class MetricHistory:
    def __init__(self):
        self.metrics = []
        self.higher = []
        self.history = {}

    def add_metric(self, metric, higher_is_better=True):
        assert metric not in self.metrics
        self.metrics.append(metric)
        self.higher.append(higher_is_better)
        self.history[metric] = []

    def add_data(self, metric, value, step):
        self.history[metric].append((step, float(value)))

    def to_dict(self):
        """JSON-serializable snapshot (for checkpoint sidecars)."""
        return {
            "metrics": list(self.metrics),
            "higher": list(self.higher),
            "history": {m: [[s, v] for s, v in hist]
                        for m, hist in self.history.items()},
        }

    def restore(self, data):
        """Merge a `to_dict` snapshot into this instance.

        Registered metrics keep their direction; snapshot-only metrics are
        registered from the snapshot. Existing entries are replaced.
        """
        for m, higher in zip(data["metrics"], data["higher"]):
            if m not in self.metrics:
                self.add_metric(m, higher_is_better=higher)
        for m, hist in data["history"].items():
            if m in self.history:
                self.history[m] = [(int(s), float(v)) for s, v in hist]

    def best_value(self, metric):
        """Returns (value, step) of the best entry, or (None, None)."""
        hist = self.history[metric]
        if not hist:
            return None, None
        values = np.array([v for _, v in hist])
        best = np.argmax(values) if self.higher[self.metrics.index(metric)] else np.argmin(values)
        step, value = hist[best]
        return value, step

    def value_at_step(self, metric, step):
        for s, v in self.history[metric]:
            if s == step:
                return v
        return None

    def latest_value(self, metric):
        hist = self.history[metric]
        if not hist:
            return None
        return max(hist, key=lambda sv: sv[0])[1]

    def print_best(self):
        for metric in self.metrics:
            value, step = self.best_value(metric)
            if "loss" in metric:
                print(f"{metric}: {value} (step {step})")
            else:
                print(f"{metric}: {value:.3f} (step {step})")

    def print_all_for_best_metric(self, metric):
        _, target_step = self.best_value(metric)
        for m in self.metrics:
            value = self.value_at_step(m, target_step)
            if "loss" in m:
                print(f"{m}: {value} (step {target_step})")
            else:
                print(f"{m}: {value:.3f} (step {target_step})")
