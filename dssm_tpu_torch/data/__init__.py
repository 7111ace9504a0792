from dssm_tpu_torch.data import trigram  # noqa: F401
from dssm_tpu_torch.data.corpus import Pairs, iter_pairs, read_pairs  # noqa: F401
from dssm_tpu_torch.data.loader import (  # noqa: F401
    Batch,
    HashedPairs,
    batch_iterator,
    eval_batches,
    hash_pairs,
    pad_batch,
    prefetch,
    select_batch,
)
from dssm_tpu_torch.data.toy import (  # noqa: F401
    ToyPairs, make_toy_pairs, train_eval_split)
