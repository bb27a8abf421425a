from gandes_tpu_torch.data.audio import load_wav, save_wav, split_audio_data
from gandes_tpu_torch.data.datasets import (
    DataLoader,
    InputSong,
    MaestroDatasetGanDes,
    MaestroDatasetMidi,
    MaestroDatasetPickle,
    MaestroDatasetTorch,
    build_window_pickle,
    my_collate,
)
