from dssm_tpu_torch.data import trigram  # noqa: F401
from dssm_tpu_torch.data.corpus import (  # noqa: F401
    Pairs,
    hash_pairs_chunked,
    iter_pairs,
    load_file_corpus,
    read_pairs,
    write_tsv,
)
from dssm_tpu_torch.data.loader import (  # noqa: F401
    Batch,
    HashedPairs,
    LockedIterator,
    batch_iterator,
    eval_batches,
    hash_pairs,
    pad_batch,
    prefetch,
    select_batch,
)
from dssm_tpu_torch.data.toy import (  # noqa: F401
    ToyPairs, make_toy_pairs, train_eval_split)
