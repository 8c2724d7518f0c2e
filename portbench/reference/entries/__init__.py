"""The reference of each entry point, one module per entry, found by the
entry's name.  Each defines:

- `nominal(mix) -> dict`: the arithmetic the configuration states;
- `prepare(batch, config, mix, precision, pool) -> state`: the work of an
  unstamped pool batch, done once;
- `submit(pool, batch, config, mix, precision, stamp) -> future`: the work
  of a stamped call that `state` lacks, from the batch as stamped (copied
  out before it returns);
- `expected(state, config, mix, first_frame_index, stamp, part)`: the
  call's output from the two.
"""
