from gandes_tpu_torch.data.audio import load_wav, save_wav
