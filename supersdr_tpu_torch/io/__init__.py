"""Host-side sources and sinks (copies of the reference's framework-free
`io/` modules): WAV files, the KiwiSDR wire protocol, WebSocket
transport, rig control (hamlib rigctld), audio output."""
