"""Spreading work over devices: the transcode farm (``farm``), the
per-device encode and decode steps (``mesh``) and their dry run
(``dryrun``)."""
