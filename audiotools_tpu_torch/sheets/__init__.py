"""Cue sheets (``cue``) and cdrdao TOC files (``toc``), read into and
written from ``audiofile.Sheet``."""
