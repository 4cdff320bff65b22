"""The lookup services: FreeDB, MusicBrainz and AccurateRip.

The port of the reference's ``audiotools_tpu/services``: each service's
disc ID, computed from a disc's layout, and its lookup over HTTP; a
lookup that cannot reach its service returns an empty result.
``lookup`` turns the replies into ``MetaData`` choices.  No device code.
"""
