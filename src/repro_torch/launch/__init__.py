"""Launchers: the production mesh as a layout plan, the dry run, and
the distributed store's rank processes (``ranks``)."""
