"""CLI surface: ``index`` and search."""
