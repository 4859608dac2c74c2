"""Device ms a event of the tracking metrics (train/metrics.py:
tracking_metrics_batch, ops/knn.py): CUDA events around the trainer's call
of it, over every evaluated event of the traced window."""


def read(t):
    v = t.spans.get("knn_ms")
    return sum(v) / len(v) if v else None
