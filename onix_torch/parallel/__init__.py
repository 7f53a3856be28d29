"""The sharded engine on one device (`onix/parallel/`)."""
