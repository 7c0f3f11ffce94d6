"""What the harness knows of each architecture, one module a name: the
key "arch" of a configuration file names `chipbench/archs/<arch>.py`
(found by `spec.arch`).  A module gives

  leaf_specs(m)                  (path, shape, dtype, scale, shift) of
                                 every weight leaf (`weights.make`)
  final_hidden(m, params, seqs, reads, bits), head(params, bits)
                                 the plain float32 reference, TF32 off,
                                 importing nothing of the program
                                 (`check.top_gaps`)
  projection_shapes(m), matmul_params_per_token(m, with_head),
  positions_flops(m, start, stop, head_from), flash_call(m, seq)
                                 the operation counts and a prefill
                                 attention call's operations and bytes
                                 (the readers)

where `m` is the configuration's "model" block.
"""
