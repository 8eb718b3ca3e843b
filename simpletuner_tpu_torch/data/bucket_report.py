"""Dataset statistics report (reference: helpers/data_backend/bucket_report.py).

The torch port's own copy of ``simpletuner_tpu/data/bucket_report.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List


def bucket_report(metadata_backend) -> Dict[str, Any]:
    """Per-bucket counts + totals + skip reasons for one dataset."""
    buckets = {
        key: len(files)
        for key, files in metadata_backend.aspect_ratio_bucket_indices.items()
    }
    skipped: Dict[str, int] = {}
    for meta in metadata_backend.image_metadata.values():
        reason = meta.get("skipped")
        if reason:
            skipped[reason] = skipped.get(reason, 0) + 1
    total = sum(buckets.values())
    return {
        "id": metadata_backend.id,
        "total_samples": total,
        "bucket_count": len(buckets),
        "buckets": dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
        "skipped": skipped,
        "largest_bucket": max(buckets, key=buckets.get) if buckets else None,
        "smallest_bucket": min(buckets, key=buckets.get) if buckets else None,
    }


def format_report(report: Dict[str, Any]) -> str:
    lines = [
        f"dataset {report['id']}: {report['total_samples']} samples in {report['bucket_count']} bucket(s)",
    ]
    for key, count in report["buckets"].items():
        share = 100.0 * count / max(report["total_samples"], 1)
        lines.append(f"  {key:>12s}  {count:6d}  ({share:4.1f}%)")
    for reason, count in report.get("skipped", {}).items():
        lines.append(f"  skipped: {count} — {reason}")
    return "\n".join(lines)


def data_plane_report(data_plane) -> List[Dict[str, Any]]:
    return [
        bucket_report(bundle.metadata_backend)
        for bundle in data_plane.bundles.values()
        if bundle.config.dataset_type in ("image", "video", "audio", "eval")
    ]
