"""Aggregation of ensemble members: prediction-level ensembling
(``ensemble``), weight averaging (``soup``) and submission packaging
(``submit``)."""

from item_alignment_torch.aggregate.ensemble import (  # noqa: F401
    ensemble_predictions,
    read_prediction_file,
    write_prediction_file,
)
from item_alignment_torch.aggregate.soup import uniform_soup  # noqa: F401
