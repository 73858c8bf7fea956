"""repro_torch.train — the training loop and the training state the port
stores in NVM.

  * ``train_step``  — chunked cross-entropy (one checkpoint a sequence
                      chunk), gradients by autograd, ``make_train_step``
                      (one process) and ``make_sharded_train_step`` (a
                      rank of the data axis of a process group);
  * ``data``        — the synthetic (seed, step) batches, bit for bit the
                      reference's, drawn on the device;
  * ``accumulate``  — microbatched float32 gradient accumulation, the
                      compression once a step;
  * ``fault_tolerance`` — heartbeats, stragglers, the elastic re-mesh;
  * ``optimizer``   — elementwise AdamW (float32 moments) with the
                      reference's warmup-cosine schedule and global-norm
                      clipping; ``OptState`` is a NamedTuple;
  * ``compression`` — int8 error-feedback gradient compression, its int8
                      wire buffer optionally written through the EXTENT
                      substrate (``memory.write``);
  * ``checkpoint``  — ``Checkpointer``: atomic, asynchronous, pruned
                      checkpoints whose approximate leaves (optimizer
                      moments) are written through the EXTENT substrate,
                      with delta elimination and a decay-and-scrub
                      integrity pass on restore.

Each mirrors its ``repro.train`` counterpart; the on-disk checkpoint
format is the reference's, so each package restores the other's.
"""
