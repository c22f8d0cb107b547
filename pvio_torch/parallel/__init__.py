"""Many sequences and many processes: `batch` (vmapped keyframe solvers),
`multi_seq` (the vmapped coupled chain, dp-sharded with a mesh), `serving`
(N `PVIO` engines behind one host loop) and `sharded_ba` (the BA over a
dp x tp `torch.distributed` process mesh). Mirrors `pvio_tpu/parallel/`."""
