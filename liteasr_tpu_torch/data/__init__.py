"""Host-side data layer: Kaldi manifests, vocab, batching, prefetching."""

from liteasr_tpu_torch.data.dataset import AudioFileDataset, RawAudioFileDataset  # noqa: F401
