"""Disc metadata lookups: the services' replies as MetaData choices.

The port of the reference's ``audiotools_tpu/services/lookup.py``:
FreeDB XMCD entries and MusicBrainz discid XML become a list of
MetaData a track; each service that answers adds one choice (one a
release for MusicBrainz), and every lookup ends with a default choice
of track numbers alone, so an offline lookup gives that choice only.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

from ..audiofile import MetaData


def parse_xmcd(xmcd_text, track_count):
    """a FreeDB XMCD entry as a list of MetaData, one a track; None
    for text that is no entry"""
    if "# xmcd" not in xmcd_text.splitlines()[0:1][0:] and \
            not xmcd_text.lstrip().startswith("# xmcd"):
        if "DTITLE" not in xmcd_text:
            return None
    fields = {}
    for line in xmcd_text.splitlines():
        match = re.match(r"^([A-Z0-9]+)=(.*)$", line.strip())
        if match is not None:
            (key, value) = match.groups()
            fields[key] = fields.get(key, "") + value

    dtitle = fields.get("DTITLE", "")
    if " / " in dtitle:
        (artist, album) = dtitle.split(" / ", 1)
    else:
        (artist, album) = ("", dtitle)
    year = fields.get("DYEAR", "") or None

    metadatas = []
    for i in range(track_count):
        ttitle = fields.get("TTITLE%d" % (i,), "")
        if " / " in ttitle:
            (track_artist, track_name) = ttitle.split(" / ", 1)
        else:
            (track_artist, track_name) = (artist, ttitle)
        metadatas.append(MetaData(track_name=track_name or None,
                                  track_number=i + 1,
                                  track_total=track_count,
                                  album_name=album or None,
                                  artist_name=track_artist or None,
                                  year=year))
    return metadatas


_MB_NS = "{http://musicbrainz.org/ns/mmd-2.0#}"


def _mb_artist(credit):
    """an <artist-credit> element as one string: each <name-credit>'s
    artist name followed by its joinphrase attribute"""
    parts = []
    for name_credit in credit.findall(_MB_NS + "name-credit"):
        name = name_credit.find(
            _MB_NS + "artist/" + _MB_NS + "name")
        parts.append(name.text or "" if name is not None else "")
        parts.append(name_credit.get("joinphrase", ""))
    return "".join(parts) or None


def _mb_release_tracks(release, track_count, disc_id):
    """one MetaData list for a <release>: album fields from the
    release, catalog and publisher from the first <label-info>,
    album_number and album_total from the <medium-list> when the disc
    id matches a medium of several, a track's own artist credit over
    the release's, and <position> track numbers; None where no medium
    matches ``disc_id``"""
    album = release.findtext(_MB_NS + "title") or None
    date = release.findtext(_MB_NS + "date") or None
    year = date.split("-")[0] if date else None
    credit = release.find(_MB_NS + "artist-credit")
    album_artist = _mb_artist(credit) if credit is not None else None

    catalog = publisher = None
    label_info = release.find(
        _MB_NS + "label-info-list/" + _MB_NS + "label-info")
    if label_info is not None:
        catalog = label_info.findtext(_MB_NS + "catalog-number") \
            or None
        publisher = label_info.findtext(
            _MB_NS + "label/" + _MB_NS + "name") or None

    # the medium whose <disc-list> carries the disc id (a release of
    # several discs lists a <medium> a disc); a release with no such
    # medium is skipped, so that it never gives another disc's tracks.
    # Without a disc id the first medium is taken.
    medium_list = release.find(_MB_NS + "medium-list")
    if medium_list is None:
        return None
    mediums = medium_list.findall(_MB_NS + "medium")
    if not mediums:
        return None
    medium = None
    if disc_id is not None:
        for candidate in mediums:
            ids = [disc.get("id") for disc in candidate.findall(
                _MB_NS + "disc-list/" + _MB_NS + "disc")]
            if str(disc_id) in ids:
                medium = candidate
                break
        if medium is None:
            return None
    else:
        medium = mediums[0]

    album_number = album_total = None
    count = medium_list.get("count")
    if count is not None and int(count) > 1:
        album_total = int(count)
        position = medium.findtext(_MB_NS + "position")
        if position is not None:
            album_number = int(position)

    tracks = []
    track_nodes = medium.findall(
        _MB_NS + "track-list/" + _MB_NS + "track")
    track_total = len(track_nodes) or track_count
    for (i, track) in enumerate(track_nodes):
        title = track.findtext(_MB_NS + "title") or None
        credit = track.find(_MB_NS + "artist-credit")
        track_artist = (_mb_artist(credit)
                        if credit is not None else None)
        recording = track.find(_MB_NS + "recording")
        if recording is not None:
            if title is None:
                title = recording.findtext(_MB_NS + "title") or None
            if track_artist is None:
                credit = recording.find(_MB_NS + "artist-credit")
                track_artist = (_mb_artist(credit)
                                if credit is not None else None)
        position = track.findtext(_MB_NS + "position")
        number = int(position) if position else (i + 1)
        tracks.append(MetaData(track_name=title,
                               track_number=number,
                               track_total=track_total,
                               album_name=album,
                               artist_name=track_artist or album_artist,
                               catalog=catalog,
                               publisher=publisher,
                               year=year,
                               album_number=album_number,
                               album_total=album_total))
    if not tracks:
        tracks = [MetaData(track_number=i + 1,
                           track_total=track_count,
                           album_name=album,
                           artist_name=album_artist,
                           catalog=catalog,
                           publisher=publisher,
                           year=year,
                           album_number=album_number,
                           album_total=album_total)
                  for i in range(track_count)]
    return tracks


def parse_musicbrainz_xml(xml_text, track_count, disc_id=None):
    """a MusicBrainz discid XML reply as MetaData choices, a list for
    each release that matches; with ``disc_id``, a release of several
    discs takes album_number and album_total from the medium carrying
    that disc ([] for a reply that does not parse)"""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError:
        return []
    choices = []
    for release in root.iter(_MB_NS + "release"):
        tracks = _mb_release_tracks(release, track_count, disc_id)
        if tracks is not None:
            choices.append(tracks)
    return choices


def metadata_lookup(cdda, musicbrainz_server="musicbrainz.org",
                    musicbrainz_port=80,
                    freedb_server="us.freedb.org", freedb_port=80,
                    use_musicbrainz=True, use_freedb=True):
    """the MetaData choices for a ``cdio.CDDA`` disc: metadata[choice]
    [track] lists, the last the default choice of track numbers alone"""
    track_count = len(cdda)
    choices = []

    if use_musicbrainz:
        from . import musicbrainz
        mb_disc_id = musicbrainz.disc_id(cdda)
        response = musicbrainz.perform_lookup(
            mb_disc_id,
            musicbrainz_server=musicbrainz_server,
            musicbrainz_port=musicbrainz_port)
        if response:
            choices.extend(parse_musicbrainz_xml(
                response, track_count, disc_id=mb_disc_id))
    if use_freedb:
        from . import freedb
        response = freedb.perform_lookup(
            freedb.disc_id(cdda), freedb_server=freedb_server,
            freedb_port=freedb_port)
        if response:
            parsed = parse_xmcd(response, track_count)
            if parsed is not None:
                choices.append(parsed)

    # the default choice: track numbers only
    choices.append([MetaData(track_number=i + 1,
                             track_total=track_count)
                    for i in range(track_count)])
    return choices


def track_metadata_lookup(audiofiles,
                          musicbrainz_server="musicbrainz.org",
                          musicbrainz_port=80,
                          freedb_server="us.freedb.org",
                          freedb_port=80,
                          use_musicbrainz=True, use_freedb=True):
    """the MetaData choices for AudioFiles taken as one CD (in
    ``dispatch.sorted_tracks`` order): metadata[choice][track] lists,
    the last the default choice of track numbers alone"""
    from ..dispatch import sorted_tracks as sort
    return lengths_metadata_lookup(
        [f.cd_frames() for f in sort(audiofiles)],
        musicbrainz_server=musicbrainz_server,
        musicbrainz_port=musicbrainz_port, freedb_server=freedb_server,
        freedb_port=freedb_port, use_musicbrainz=use_musicbrainz,
        use_freedb=use_freedb)


def lengths_metadata_lookup(track_frames,
                            musicbrainz_server="musicbrainz.org",
                            musicbrainz_port=80,
                            freedb_server="us.freedb.org",
                            freedb_port=80,
                            use_musicbrainz=True, use_freedb=True):
    """the MetaData choices for a CD whose tracks are ``track_frames``
    CD frames long, the first after the 150-frame lead-in (files taken
    as one CD, or a DVD-Audio title's tracks): metadata[choice][track]
    lists, the last the default choice of track numbers alone"""
    from .freedb import DiscID as FreeDBDiscID
    from .musicbrainz import DiscID as MBDiscID

    track_count = len(track_frames)
    offsets = [150 + sum(track_frames[0:i])
               for i in range(track_count)]
    lead_out_offset = 150 + sum(track_frames)

    choices = []
    if track_count:
        if use_musicbrainz:
            from . import musicbrainz
            response = musicbrainz.perform_lookup(
                MBDiscID(first_track_number=1,
                         last_track_number=track_count,
                         lead_out_offset=lead_out_offset,
                         offsets=offsets),
                musicbrainz_server=musicbrainz_server,
                musicbrainz_port=musicbrainz_port)
            if response:
                choices.extend(parse_musicbrainz_xml(response,
                                                     track_count))
        if use_freedb:
            from . import freedb
            response = freedb.perform_lookup(
                FreeDBDiscID(offsets=offsets,
                             total_length=sum(track_frames) - 1,
                             track_count=track_count),
                freedb_server=freedb_server,
                freedb_port=freedb_port)
            if response:
                parsed = parse_xmcd(response, track_count)
                if parsed is not None:
                    choices.append(parsed)

    choices.append([MetaData(track_number=i + 1,
                             track_total=track_count)
                    for i in range(track_count)])
    return choices


def sheet_metadata_lookup(sheet, total_pcm_frames, sample_rate,
                          musicbrainz_server="musicbrainz.org",
                          musicbrainz_port=80,
                          freedb_server="us.freedb.org",
                          freedb_port=80,
                          use_musicbrainz=True, use_freedb=True):
    """the MetaData choices for an album image and its cue sheet, the
    sheet's track layout taken as the disc's: metadata[choice][track]
    lists, the last the default choice of track numbers alone"""
    from .freedb import DiscID as FreeDBDiscID
    from .musicbrainz import DiscID as MBDiscID

    def _track_offset(track):
        """INDEX 01's offset in CD frames (the track's audio start —
        higher sub-indexes must not shift the disc ID)"""
        try:
            return int(track.index(1).offset() * 75)
        except KeyError:
            return int(min(i.offset() for i in track.indexes()) * 75)

    tracks = list(sheet.tracks())
    track_count = len(tracks)
    total_cd_frames = (total_pcm_frames * 75) // sample_rate
    offsets = [150 + _track_offset(t) for t in tracks]
    lead_out_offset = 150 + total_cd_frames

    choices = []
    if track_count:
        if use_musicbrainz:
            from . import musicbrainz
            response = musicbrainz.perform_lookup(
                MBDiscID(first_track_number=1,
                         last_track_number=track_count,
                         lead_out_offset=lead_out_offset,
                         offsets=offsets),
                musicbrainz_server=musicbrainz_server,
                musicbrainz_port=musicbrainz_port)
            if response:
                choices.extend(parse_musicbrainz_xml(response,
                                                     track_count))
        if use_freedb:
            from . import freedb
            response = freedb.perform_lookup(
                FreeDBDiscID(offsets=offsets,
                             total_length=total_cd_frames - 1,
                             track_count=track_count),
                freedb_server=freedb_server,
                freedb_port=freedb_port)
            if response:
                parsed = parse_xmcd(response, track_count)
                if parsed is not None:
                    choices.append(parsed)

    choices.append([MetaData(track_number=i + 1,
                             track_total=track_count)
                    for i in range(track_count)])
    return choices


def accuraterip_lookup(sorted_tracks,
                       accuraterip_server="www.accuraterip.com",
                       accuraterip_port=80):
    """the AccurateRip database's entries for AudioFiles in sorted
    order, taken as one CD laid out by their CD frame lengths:
    {track_number: [(confidence, crc, crc2), ...]} ({} for no files,
    empty lists offline)"""
    if len(sorted_tracks) == 0:
        return {}

    def track_number(track, default):
        metadata = track.get_metadata()
        if metadata is not None and metadata.track_number is not None:
            return metadata.track_number
        return default

    from .accuraterip import DiscID as ARDiscID
    from .accuraterip import perform_lookup
    from .freedb import DiscID as FreeDBDiscID

    track_numbers = [track_number(track, i + 1)
                     for (i, track) in enumerate(sorted_tracks)]
    track_frames = [track.cd_frames() for track in sorted_tracks]
    track_offsets = [0]
    for length in track_frames[:-1]:
        track_offsets.append(length + track_offsets[-1])
    lead_out_offset = sum(track_frames)

    freedb_disc_id = FreeDBDiscID(
        offsets=[o + 150 for o in track_offsets],
        total_length=lead_out_offset,
        track_count=len(sorted_tracks))

    return perform_lookup(
        ARDiscID(track_numbers, track_offsets, lead_out_offset,
                 freedb_disc_id),
        accuraterip_server, accuraterip_port)


def accuraterip_sheet_lookup(sheet, total_pcm_frames, sample_rate,
                             accuraterip_server="www.accuraterip.com",
                             accuraterip_port=80):
    """the AccurateRip database's entries for an album image laid out by
    a Sheet, whose index offsets stand in for the CD's track offsets.

    returns {track_number: [(confidence, crc, crc2), ...]}
    (may be a dict of empty lists offline / when not found)"""
    from .accuraterip import DiscID as ARDiscID
    from .accuraterip import perform_lookup
    from .freedb import DiscID as FreeDBDiscID

    def _track_offset(track):
        try:
            return int(track.index(1).offset() * 75)
        except KeyError:
            return int(min(i.offset() for i in track.indexes()) * 75)

    tracks = list(sheet.tracks())
    track_numbers = [t.number() for t in tracks]
    track_offsets = [_track_offset(t) for t in tracks]
    lead_out_offset = (total_pcm_frames * 75) // sample_rate
    freedb_disc_id = FreeDBDiscID(
        offsets=[o + 150 for o in track_offsets],
        total_length=(total_pcm_frames * 75) // sample_rate,
        track_count=len(tracks))

    return perform_lookup(
        ARDiscID(track_numbers, track_offsets, lead_out_offset,
                 freedb_disc_id),
        accuraterip_server, accuraterip_port)
