"""Raw telemetry decoders and the ingest run — the port's own copies of
`onix/ingest/{run,parsers,pcap,nfdecode}.py`."""
