"""Analyst feedback loop, read side: the compiled noise filter
(`filter`), the port of `onix/feedback/`."""
