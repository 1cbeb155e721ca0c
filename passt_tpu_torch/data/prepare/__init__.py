"""Offline data preparation (port of passt_tpu/data/prepare): dataset
metadata, an in-process WAV decoder and resampler, mp3 encoding
(libmp3lame) and Ogg/Vorbis decoding (libvorbisfile) by ctypes, and the
one writer of the HDF5 container schema the recipes read. numpy, scipy,
h5py and ctypes only; h5py is imported where a container is opened."""

from passt_tpu_torch.data.prepare.pack_hdf5 import (
    StreamingPacker,
    pack_bytes_hdf5,
    pack_waveform_hdf5,
)

__all__ = ["StreamingPacker", "pack_waveform_hdf5", "pack_bytes_hdf5"]
