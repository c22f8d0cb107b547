"""Many sequences on one device: `batch` (vmapped keyframe solvers),
`multi_seq` (the vmapped coupled chain) and `serving` (N `PVIO` engines
behind one host loop). Mirrors `pvio_tpu/parallel/`; the sharded solver
(`sharded_ba`) and the dp-sharded chain are not ported yet."""
