"""Raw telemetry decoders, the ingest run and the landing-directory
watchers — the port's own copies of
`onix/ingest/{run,parsers,pcap,nfdecode,watcher,mpingest}.py`."""
