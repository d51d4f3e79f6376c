"""Data substrate of the port: the synthetic latent corpus, the stub
feature extractor, the clustering-driven per-expert streams and the
token batches of LM training."""

from repro_torch.data.features import FEATURE_DIM, extract_features
from repro_torch.data.pipeline import (ExpertDataStream, RouterDataStream,
                                       fit_clusters, lm_batch)
from repro_torch.data.synthetic import (SyntheticSpec, category_stats,
                                        fit_gaussian, frechet_distance,
                                        pairwise_diversity, sample_batch,
                                        sample_fid)
