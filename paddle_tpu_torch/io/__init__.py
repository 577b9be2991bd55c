"""Input helpers of the port (bucketing only in the serving slice)."""

from .bucketing import shape_bucket

__all__ = ["shape_bucket"]
