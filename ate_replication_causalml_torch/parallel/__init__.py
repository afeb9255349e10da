"""Multi-GPU on ``torch.distributed``, one process (rank) per card.

* :mod:`.multihost` — joining the world (``init_multihost``) and the
  pod mesh layout;
* :mod:`.mesh` — named axes (``boot``, ``tree``, ``fold``, ``data``)
  over the ranks, layout tags and the port's collectives;
* :mod:`.shardio` — the metered artifact plane (commit, reshard,
  handoff, host gather, padded row shards);
* :mod:`.retry` — failure detection and classified retry of shards;
* :mod:`.spawn` — N ranks of a fresh world from one process;
* :mod:`.dryrun` — ``dryrun_multigpu``, every sharded leg on N ranks.
"""
