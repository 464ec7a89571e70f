"""Continuous-batching serving of packed weights."""
