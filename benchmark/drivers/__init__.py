"""One driver per kind of work a cell runs."""
