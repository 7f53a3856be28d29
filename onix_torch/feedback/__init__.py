"""Analyst feedback loop, read side: the compiled noise filter
(`filter`) and the filtered selection scans with their serve-gated
dispatchers (`rescore`), the port of `onix/feedback/`."""
