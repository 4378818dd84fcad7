"""The port's audio readers against stt_tpu's on the same bytes: `read_audio`
by extension, `read_wav` resampling, `resample`, the loudness helpers, and
each decoder (FLAC, SPHERE, Ogg Vorbis, Ogg Opus and the Opus-in-SDB blob,
MP3). Arrays must be equal, not close: the port's modules are copies.

Every fixture is made here from a seed: FLAC by the small encoder of
chip_smoke.py (VERBATIM and FIXED subframes, Rice-coded residuals), SPHERE
by `write_sph` (PCM, mu-law, stereo), Ogg Vorbis through the system
libvorbisenc, Ogg Opus through libopus with pages from libogg, MP3 through
libmp3lame, each by ctypes. Where the machine lacks one of those
libraries, its test skips and says which.
"""

import ctypes
import ctypes.util
import os
import sys
import wave

import numpy as np
import pytest

import stt_tpu.data.audio as jax_audio
import stt_tpu.data.opus as jax_opus
from stt_tpu.data.flac import read_flac as jax_read_flac
from stt_tpu.data.mp3 import read_mp3 as jax_read_mp3
from stt_tpu.data.ogg import probe_ogg_file as jax_probe_ogg_file
from stt_tpu.data.sph import read_sph as jax_read_sph
from stt_tpu.data.vorbis import read_vorbis as jax_read_vorbis
import stt_tpu_torch.data.audio as audio
import stt_tpu_torch.data.opus as opus
from stt_tpu_torch.data.flac import read_flac
from stt_tpu_torch.data.mp3 import mp3_available, read_mp3
from stt_tpu_torch.data.ogg import probe_ogg_file
from stt_tpu_torch.data.sph import read_sph, sph_to_wav, write_sph
from stt_tpu_torch.data.vorbis import read_vorbis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import write_flac  # noqa: E402


def tone(seconds: float, rate: int, seed: int, channels: int = 1) -> np.ndarray:
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.3 * np.sin(2 * np.pi * rs.uniform(150, 600) * t) + 0.02 * rs.randn(len(t))
    if channels > 1:
        x = np.stack([x * (0.5 + 0.5 * c) for c in range(channels)], axis=1)
    return np.clip(x, -1, 1).astype(np.float32)


def pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


def assert_same(got, want):
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])


def library(name: str, soname: str):
    found = ctypes.util.find_library(name) or soname
    try:
        return ctypes.CDLL(found)
    except OSError:
        pytest.skip(f"lib{name} is not on this machine")


# --- FLAC, SPHERE, WAV and resampling ---------------------------------------

@pytest.mark.parametrize("order", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("rate", [8000, 16000])
def test_flac_decodes_as_stt_tpu_and_losslessly(tmp_path, order, rate):
    x = tone(1.3, rate, seed=rate + (order or 9))
    path = str(tmp_path / "a.flac")
    write_flac(path, x, rate, order=order, block=4096)
    got = read_flac(path)
    assert_same(got, jax_read_flac(path))
    np.testing.assert_array_equal(got[0], pcm16(x) / np.float32(32768.0))
    assert_same(audio.read_audio(path), jax_audio.read_audio(path))
    assert_same(audio.read_audio(path, desired_rate=16000),
                jax_audio.read_audio(path, desired_rate=16000))


@pytest.mark.parametrize("coding,channels,big_endian", [
    ("pcm", 1, False), ("pcm", 1, True), ("ulaw", 1, False), ("pcm", 2, False)])
def test_sph_decodes_as_stt_tpu(tmp_path, coding, channels, big_endian):
    path = str(tmp_path / "a.sph")
    write_sph(path, tone(0.8, 8000, 3, channels), 8000, coding=coding, big_endian=big_endian)
    with open(path, "rb") as f:
        written = f.read()
    jax_path = str(tmp_path / "b.sph")
    from stt_tpu.data.sph import write_sph as jax_write_sph

    jax_write_sph(jax_path, tone(0.8, 8000, 3, channels), 8000, coding=coding,
                  big_endian=big_endian)
    with open(jax_path, "rb") as f:
        assert f.read() == written
    assert_same(read_sph(path), jax_read_sph(path))
    assert_same(audio.read_audio(path), jax_audio.read_audio(path))  # stereo averaged
    assert_same(audio.read_audio(path, desired_rate=16000),
                jax_audio.read_audio(path, desired_rate=16000))
    sph_to_wav(path, str(tmp_path / "a.wav"), desired_rate=16000)
    assert_same(audio.read_wav(str(tmp_path / "a.wav")), jax_audio.read_wav(str(tmp_path / "a.wav")))


@pytest.mark.parametrize("src,dst", [(8000, 16000), (16000, 8000), (44100, 16000), (22050, 8000),
                                     (16000, 16000)])
def test_resample_and_read_wav_at_another_rate(tmp_path, src, dst):
    x = tone(0.7, src, seed=src)
    got = audio.resample(x, src, dst)
    np.testing.assert_array_equal(got, jax_audio.resample(x, src, dst))
    assert got.dtype == np.float32 and abs(len(got) - len(x) * dst / src) <= 1
    path = str(tmp_path / "a.wav")
    audio.write_wav(path, x, src)
    assert_same(audio.read_wav(path, desired_rate=dst), jax_audio.read_wav(path, desired_rate=dst))
    assert_same(audio.read_audio(path, desired_rate=dst),
                jax_audio.read_audio(path, desired_rate=dst))


def test_loudness_helpers_and_unknown_formats(tmp_path):
    x = tone(0.5, 16000, 4) * 0.5
    for name in ("rms_dbfs", "max_dbfs"):
        assert getattr(audio, name)(x) == getattr(jax_audio, name)(x)
        assert getattr(audio, name)(np.zeros(0, np.float32)) == -np.inf
    assert audio.gain_db_to_ratio(-6.0) == jax_audio.gain_db_to_ratio(-6.0)
    for target in (0.0, -3.0, -12.5):
        np.testing.assert_array_equal(audio.normalize_audio(x, target),
                                      jax_audio.normalize_audio(x, target))
    assert audio.duration_seconds(24000, 8000) == jax_audio.duration_seconds(24000, 8000) == 3.0
    path = str(tmp_path / "a.aiff")
    open(path, "wb").close()
    for read in (audio.read_audio, jax_audio.read_audio):
        with pytest.raises(ValueError, match="unsupported audio format"):
            read(path)


# --- Ogg Vorbis and Ogg Opus, with pages from libogg -------------------------

class OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.c_void_p), ("bytes", ctypes.c_long), ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long), ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


class OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.c_void_p), ("header_len", ctypes.c_long),
                ("body", ctypes.c_void_p), ("body_len", ctypes.c_long)]


class OggStream:
    """An Ogg bitstream written by libogg."""

    def __init__(self, serial: int = 7):
        self.ogg = library("ogg", "libogg.so.0")
        for name in ("ogg_stream_packetin", "ogg_stream_pageout", "ogg_stream_flush"):
            getattr(self.ogg, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.state = ctypes.create_string_buffer(1024)  # ogg_stream_state (~400 bytes)
        self.ogg.ogg_stream_init(self.state, serial)
        self.pages = []
        self.packetno = 0

    def packet(self, data: bytes, granule: int, bos=False, eos=False) -> None:
        buf = ctypes.create_string_buffer(data, len(data))
        op = OggPacket(ctypes.cast(buf, ctypes.c_void_p), len(data), int(bos), int(eos),
                       granule, self.packetno)
        self.packetno += 1
        self.packetin(op)

    def packetin(self, op: OggPacket) -> None:
        self.ogg.ogg_stream_packetin(self.state, ctypes.byref(op))

    def drain(self, flush: bool = False) -> None:
        page = OggPage()
        take = self.ogg.ogg_stream_flush if flush else self.ogg.ogg_stream_pageout
        while take(self.state, ctypes.byref(page)):
            self.pages.append(ctypes.string_at(page.header, page.header_len)
                              + ctypes.string_at(page.body, page.body_len))

    def bytes(self) -> bytes:
        self.drain(flush=True)
        self.ogg.ogg_stream_clear(self.state)
        return b"".join(self.pages)


def write_vorbis(path: str, x: np.ndarray, rate: int, quality: float = 0.4) -> None:
    """Mono Ogg Vorbis through libvorbisenc (VBR at `quality`)."""
    enc = library("vorbisenc", "libvorbisenc.so.2")
    vorbis = library("vorbis", "libvorbis.so.0")
    info, comment = ctypes.create_string_buffer(512), ctypes.create_string_buffer(512)
    dsp, block = ctypes.create_string_buffer(4096), ctypes.create_string_buffer(4096)
    vorbis.vorbis_info_init(info)
    assert enc.vorbis_encode_init_vbr(info, 1, rate, ctypes.c_float(quality)) == 0
    vorbis.vorbis_comment_init(comment)
    assert vorbis.vorbis_analysis_init(dsp, info) == 0
    vorbis.vorbis_block_init(dsp, block)
    stream = OggStream()
    headers = [OggPacket() for _ in range(3)]
    vorbis.vorbis_analysis_headerout(dsp, comment, *(ctypes.byref(h) for h in headers))
    for h in headers:
        stream.packetin(h)
    stream.drain(flush=True)
    vorbis.vorbis_analysis_buffer.restype = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    packet = OggPacket()

    def pump():
        while vorbis.vorbis_analysis_blockout(dsp, block) == 1:
            vorbis.vorbis_analysis(block, None)
            vorbis.vorbis_bitrate_addblock(block)
            while vorbis.vorbis_bitrate_flushpacket(dsp, ctypes.byref(packet)):
                stream.packetin(packet)
                stream.drain()

    samples = np.ascontiguousarray(x, np.float32)
    for start in range(0, len(samples), 1024):
        piece = samples[start:start + 1024]
        channels = vorbis.vorbis_analysis_buffer(dsp, len(piece))
        ctypes.memmove(channels[0], piece.ctypes.data, piece.nbytes)
        vorbis.vorbis_analysis_wrote(dsp, len(piece))
        pump()
    vorbis.vorbis_analysis_wrote(dsp, 0)
    pump()
    data = stream.bytes()
    for name, state in (("vorbis_block_clear", block), ("vorbis_dsp_clear", dsp),
                        ("vorbis_comment_clear", comment), ("vorbis_info_clear", info)):
        getattr(vorbis, name)(state)
    with open(path, "wb") as f:
        f.write(data)


def write_ogg_opus(path: str, x: np.ndarray, channels: int = 1) -> None:
    """Ogg Opus at 48 kHz (RFC 7845: OpusHead, OpusTags, 20 ms packets)."""
    if not opus.opus_available():
        pytest.skip("libopus is not on this machine")
    pre_skip, frame = 312, 960
    stream = OggStream(serial=11)
    head = b"OpusHead" + bytes([1, channels]) + pre_skip.to_bytes(2, "little")
    head += (48000).to_bytes(4, "little") + (0).to_bytes(2, "little") + bytes([0])
    stream.packet(head, 0, bos=True)
    stream.packet(b"OpusTags" + (4).to_bytes(4, "little") + b"test" + bytes(4), 0)
    stream.drain(flush=True)
    encoder = opus.OpusEncoder(48000, channels)
    pcm = pcm16(x).reshape(len(x), channels)
    end = len(x) + pre_skip  # the decoder's output starts pre_skip samples late
    n_frames = -(-end // frame)
    pcm = np.concatenate([pcm, np.zeros((n_frames * frame - len(pcm), channels), np.int16)])
    for i in range(n_frames):
        granule = min((i + 1) * frame, end)
        stream.packet(encoder.encode(pcm[i * frame:(i + 1) * frame], frame), granule,
                      eos=i == n_frames - 1)
        stream.drain()
    with open(path, "wb") as f:
        f.write(stream.bytes())


@pytest.mark.parametrize("rate", [8000, 16000])
def test_vorbis_decodes_as_stt_tpu(tmp_path, rate):
    path = str(tmp_path / "a.ogg")
    x = tone(0.6, rate, seed=rate)
    write_vorbis(path, x, rate)
    got = read_vorbis(path)
    assert_same(got, jax_read_vorbis(path))
    assert got[1] == rate and len(got[0]) == len(x)
    # lossy, but the tone: the same spectral peak and loudness (at 16 kHz both
    # packages' decoders put out the signal 256 samples late, ROADMAP.md 3)
    spectrum = lambda a: int(np.abs(np.fft.rfft(a)).argmax())
    assert spectrum(got[0]) == spectrum(x)
    assert audio.rms_dbfs(got[0]) == pytest.approx(audio.rms_dbfs(x), abs=0.5)
    assert_same(audio.read_audio(path, desired_rate=16000),
                jax_audio.read_audio(path, desired_rate=16000))
    assert vars(probe_ogg_file(path)) == vars(jax_probe_ogg_file(path))


@pytest.mark.parametrize("channels", [1, 2])
def test_ogg_opus_decodes_as_stt_tpu(tmp_path, channels):
    path = str(tmp_path / "a.opus")
    x = tone(0.5, 48000, seed=channels, channels=channels)
    write_ogg_opus(path, x, channels)
    got = opus.read_ogg_opus_file(path)
    assert_same(got, jax_opus.read_ogg_opus_file(path))
    assert got[0].shape == (len(x), channels)
    assert_same(audio.read_audio(path, desired_rate=16000),
                jax_audio.read_audio(path, desired_rate=16000))
    assert vars(probe_ogg_file(path)) == vars(jax_probe_ogg_file(path))


@pytest.mark.parametrize("rate,bitrate", [(16000, None), (8000, 12000), (16000, 3200)])
def test_opus_blob_and_codec_round_trip_equal_stt_tpu(rate, bitrate):
    if not opus.opus_available():
        pytest.skip("libopus is not on this machine")
    import io

    x = tone(0.7, rate, seed=rate)
    blobs = []
    for module in (opus, jax_opus):
        buf = io.BytesIO()
        module.write_opus(buf, pcm16(x).tobytes(), rate=rate, bitrate=bitrate)
        blobs.append(buf.getvalue())
    assert blobs[0] == blobs[1]
    assert opus.read_opus(io.BytesIO(blobs[0])) == jax_opus.read_opus(io.BytesIO(blobs[0]))
    np.testing.assert_array_equal(opus.codec_round_trip(x, rate, bitrate or 16000),
                                  jax_opus.codec_round_trip(x, rate, bitrate or 16000))


def write_mp3(path: str, x: np.ndarray, rate: int) -> None:
    """Mono MP3 at 64 kbit/s through libmp3lame."""
    lame = library("mp3lame", "libmp3lame.so.0")
    lame.lame_init.restype = ctypes.c_void_p
    gf = ctypes.c_void_p(lame.lame_init())
    for setter, value in (("lame_set_in_samplerate", rate), ("lame_set_num_channels", 1),
                          ("lame_set_brate", 64), ("lame_set_mode", 3)):
        getattr(lame, setter)(gf, value)
    assert lame.lame_init_params(gf) == 0
    pcm = pcm16(x)
    out = ctypes.create_string_buffer(len(pcm) * 2 + 7200)
    n = lame.lame_encode_buffer(gf, pcm.ctypes.data_as(ctypes.c_void_p),
                                pcm.ctypes.data_as(ctypes.c_void_p), len(pcm), out, len(out))
    n += lame.lame_encode_flush(gf, ctypes.byref(out, n), len(out) - n)
    lame.lame_close(gf)
    with open(path, "wb") as f:
        f.write(out.raw[:n])


def test_mp3_decodes_as_stt_tpu(tmp_path):
    if not mp3_available():
        pytest.skip("libmpg123 is not on this machine")
    path = str(tmp_path / "a.mp3")
    x = tone(0.8, 16000, seed=5)
    write_mp3(path, x, 16000)
    got = read_mp3(path)
    assert_same(got, jax_read_mp3(path))
    assert got[1] == 16000 and len(got[0]) >= len(x)
    assert_same(audio.read_audio(path, desired_rate=8000),
                jax_audio.read_audio(path, desired_rate=8000))


def test_wav_widths_and_channels_read_as_stt_tpu(tmp_path):
    x = tone(0.3, 16000, 6, channels=2)
    for width, data in ((1, (x * 127 + 128).astype(np.uint8)), (2, pcm16(x)),
                        (4, (x * 2 ** 31).astype(np.int32))):
        path = str(tmp_path / f"w{width}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(16000)
            w.writeframes(data.tobytes())
        assert_same(audio.read_audio(path), jax_audio.read_audio(path))
