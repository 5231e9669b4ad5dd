"""The sum of gathered rows by owner (GIN's aggregation and readout)."""
from .owner_sum import (LONG_ROW, SOURCE, Segments, backward_launches,
                        launches, owner_sum, owner_sum_plain, segments,
                        segments_by_source, segments_from_owners)

__all__ = ["LONG_ROW", "SOURCE", "Segments", "backward_launches", "launches",
           "owner_sum", "owner_sum_plain", "segments", "segments_by_source",
           "segments_from_owners"]
