# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Batched online scoring of the certified regularization path, the
counterpart of ``repro.serve``:

* :class:`PathStore` -- the ``(L, p)`` coefficient stack on the device,
  versioned, hot-swappable without dropping batches in flight;
* :mod:`~repro_torch.serve.ingest` -- deterministic hashed sparse-feature
  ingestion, packing request batches into the training kernels' slab
  layout;
* :class:`RequestBatcher` -- accumulate/drain batching with power-of-two
  shape classes, a bounded queue (:class:`Overloaded`) and per-request
  deadlines shed at drain;
* :class:`PathScorer` -- one ``slab_path_spmv`` launch per batch, each
  request row reading its own lambda's coefficients; scores
  bit-identical to ``LogisticL1.decision_function``. Non-finite scores
  quarantine the published version and pin the store back to its last
  good snapshot (:class:`NonFiniteScores` only if that fails too).

Entry point: ``python -m repro_torch.launch.serve_glm``.
"""
from repro_torch.serve.batcher import Overloaded, RequestBatcher, batch_capacity
from repro_torch.serve.ingest import (InvalidRequest, PackedBatch, encode_request,
                                      hash_token, k_capacity, pack_requests)
from repro_torch.serve.scoring import NonFiniteScores, PathScorer, make_path_margins
from repro_torch.serve.store import PathStore, StoreSnapshot

__all__ = ["InvalidRequest", "NonFiniteScores", "Overloaded", "PackedBatch", "PathScorer",
           "PathStore", "RequestBatcher", "StoreSnapshot", "batch_capacity",
           "encode_request", "hash_token", "k_capacity", "make_path_margins",
           "pack_requests"]
