"""The mesh forms of the port: the receiver chain sharded over a
('chan', 'time') mesh (`sharded_chain`), the wideband pipeline sharded over
time and then over channels (`sharded_wideband`), the distributed FFT
(`dist_fft`), the 2-stage pipeline (`pipeline`), ingest, the traffic model
and a dry run of them all. Counterpart of `supersdr_tpu/parallel/`.

In this package a mesh lives on one device: every shard is a slice of a
tensor axis there (as the reference's own tests run its mesh on virtual
CPU devices). `collectives` is the one module that moves data between
shards; a transport across devices belongs under it and nothing above it
assumes one device."""
