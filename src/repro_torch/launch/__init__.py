"""Launchers: the production mesh as a layout plan, and the dry run."""
