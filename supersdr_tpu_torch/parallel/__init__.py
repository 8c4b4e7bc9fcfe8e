"""The mesh forms of the port: the receiver chain sharded over a
('chan', 'time') mesh (`sharded_chain`), the wideband pipeline sharded over
time and then over channels (`sharded_wideband`), the distributed FFT
(`dist_fft`), the 2-stage pipeline (`pipeline`), ingest, the traffic model
and a dry run of them all. Counterpart of `supersdr_tpu/parallel/`.

A mesh's shards are slices of a tensor axis on one device: all of them in
one process (as the reference's own tests run its mesh on virtual CPU
devices), or, with a `torch.distributed` group, each process's share of
the time shards (`launch` starts such processes). `collectives` is the one
module that moves data between shards, in a process or across processes
(gloo on the CPU, CUDA IPC between processes on one card); nothing above
it assumes where the shards are."""
