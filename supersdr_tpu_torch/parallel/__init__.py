"""The mesh forms of the port: the receiver chain sharded over a
('chan', 'time') mesh. Counterpart of `supersdr_tpu/parallel/`.

In this package a mesh lives on one device: every shard of the `chan` and
`time` axes is a slice of a leading tensor axis there (as the reference's
own tests run its mesh on virtual CPU devices). `collectives` is the one
module that moves data between time shards; a transport across devices
belongs under it and nothing above it assumes one device."""
