"""MovieLens reader (reference: python/paddle/dataset/movielens.py).

Reference API: ``train()`` / ``test()`` → reader of
(user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
score).  Synthetic stand-in: each user and movie carries a latent vector;
score = clipped dot product — exactly the structure the recommender book
test's twin-tower model (embeddings → cos_sim → regression) can fit.
"""

import numpy as np

MAX_USER_ID = 100
MAX_MOVIE_ID = 80
AGE_TABLE = list(range(7))
MAX_JOB_ID = 20
NUM_CATEGORIES = 10
TITLE_VOCAB = 50
TITLE_LEN = 4
_LATENT = 6

_rng = np.random.RandomState(123)
_user_vec = _rng.randn(MAX_USER_ID + 1, _LATENT)
_movie_vec = _rng.randn(MAX_MOVIE_ID + 1, _LATENT)


def max_user_id():
    return MAX_USER_ID


def max_movie_id():
    return MAX_MOVIE_ID


def max_job_id():
    return MAX_JOB_ID


def age_table():
    return AGE_TABLE


def _reader(n_samples, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            uid = rng.randint(1, MAX_USER_ID + 1)
            mid = rng.randint(1, MAX_MOVIE_ID + 1)
            gender = uid % 2
            age = uid % len(AGE_TABLE)
            job = uid % MAX_JOB_ID
            categories = [mid % NUM_CATEGORIES,
                          (mid // 3) % NUM_CATEGORIES]
            title = [(mid * 7 + k) % TITLE_VOCAB for k in range(TITLE_LEN)]
            raw = float(_user_vec[uid] @ _movie_vec[mid])
            score = float(np.clip(3.0 + raw, 1.0, 5.0))
            yield (uid, gender, age, job, mid, categories, title, score)
    return reader


def train():
    return _reader(4000, seed=0)


def test():
    return _reader(400, seed=1)
