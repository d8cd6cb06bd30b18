"""The synthetic training oracle."""
from .synthetic import SyntheticTalkingHead, two_blob_occupancy

__all__ = ["SyntheticTalkingHead", "two_blob_occupancy"]
