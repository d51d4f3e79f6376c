"""Data substrate of the port: the synthetic latent corpus, the stub
feature extractor and the clustering-driven per-expert streams (the
token batches of LM training wait with it, ROADMAP A.9b)."""

from repro_torch.data.features import FEATURE_DIM, extract_features
from repro_torch.data.pipeline import (ExpertDataStream, RouterDataStream,
                                       fit_clusters)
from repro_torch.data.synthetic import (SyntheticSpec, category_stats,
                                        fit_gaussian, frechet_distance,
                                        pairwise_diversity, sample_batch,
                                        sample_fid)
