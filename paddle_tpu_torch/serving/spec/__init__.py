"""Speculative decoding for the serving engine (port of
`paddle_tpu/serving/spec`): a cheap proposer drafts up to K tokens a
sequence, one bucketed verify launch scores them all against the paged
cache, and the engine keeps the longest verified prefix plus one
correction or bonus token. Rejected drafts roll back through
`BlockAllocator.truncate_sequence`."""
from .draft_model import DraftModelProposer
from .proposer import NgramProposer, Proposer

__all__ = ["Proposer", "NgramProposer", "DraftModelProposer"]
