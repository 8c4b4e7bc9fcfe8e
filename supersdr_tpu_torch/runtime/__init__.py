"""Streaming runtime: the receiver chain's fused tail and the wideband
channelizer → N-receiver pipeline."""
