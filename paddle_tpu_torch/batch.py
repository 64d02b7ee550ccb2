"""``paddle.batch`` (reference python/paddle/batch.py; counterpart
``paddle_tpu.batch``): group a sample reader into a batch reader."""


def batch(reader_creator, batch_size, drop_last=False):
    def batch_reader():
        buf = []
        for sample in reader_creator():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
