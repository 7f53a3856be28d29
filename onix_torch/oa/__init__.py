"""Operational analytics, the port of `onix/oa/`: the batch engine
(`engine`, with its enrichment `components` and reputation clients
`repclients`), feedback capture (`feedback`), the notebook templates
(`notebooks`) and their kernels (`kernel`), the static dashboards
(`ui/`) and the HTTP server (`serve`)."""
