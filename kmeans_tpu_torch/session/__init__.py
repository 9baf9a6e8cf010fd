"""Session/state layer: the reference's document model, metrics and schema.

Copies of ``kmeans_tpu/session/``; ``auto_assign`` fits on the port's
device."""

from kmeans_tpu_torch.session.bridge import (
    auto_assign,
    cards_to_features,
    dataset_to_document,
)
from kmeans_tpu_torch.session.document import CentroidLimitError, Document
from kmeans_tpu_torch.session.metrics import (
    cohesion_for,
    metrics_deltas,
    norm_tokens,
    snapshot_metrics,
    suggestion_from_counts,
    title_case,
    tokens_for_card,
    trait_counts_for,
)
from kmeans_tpu_torch.session.schema import (
    export_filename,
    export_json,
    import_json,
    load,
    save,
    to_plain,
)
from kmeans_tpu_torch.session.seeds import (
    JESSICA,
    TEST_ITEMS,
    dedupe_seeds,
    ensure_jessica_once,
    hard_reset,
    populate_test_data,
)

__all__ = [
    "auto_assign",
    "cards_to_features",
    "dataset_to_document",
    "CentroidLimitError",
    "Document",
    "cohesion_for",
    "metrics_deltas",
    "norm_tokens",
    "snapshot_metrics",
    "suggestion_from_counts",
    "title_case",
    "tokens_for_card",
    "trait_counts_for",
    "export_filename",
    "export_json",
    "import_json",
    "load",
    "save",
    "to_plain",
    "JESSICA",
    "TEST_ITEMS",
    "dedupe_seeds",
    "ensure_jessica_once",
    "hard_reset",
    "populate_test_data",
]
