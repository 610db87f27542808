from repro_torch.data.synthetic import synthetic_dataset  # noqa: F401
from repro_torch.data.mnist_like import mnist_like_dataset  # noqa: F401
from repro_torch.data.charlm import shakespeare_like_dataset  # noqa: F401
from repro_torch.data.partition import power_law_sizes, train_test_split_clients  # noqa: F401
from repro_torch.data.batching import batch_iterator, epoch_batches  # noqa: F401
