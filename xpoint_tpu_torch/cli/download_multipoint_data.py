"""Download the MULTIPOINT dataset (port of
``cli/download_multipoint_data.py``).

    python -m xpoint_tpu_torch.cli.download_multipoint_data [-d data] [-f]
        [--test-url URL] [--train-url URL] [--labels-url URL]

Needs network access; without it, place the HDF5 files under
``--target-dir`` by hand. A file that exists is kept unless ``-f`` is
given, and then nothing is fetched for it; ``requests`` is imported only
to fetch. The JAX CLI's tqdm bar is a line of megabytes here (the port
does not use tqdm, which the card's machine lacks).
"""
import argparse
import os

BASE_URL = ('http://robotics.ethz.ch/~asl-datasets/'
            '2020_ALTAIR_multispectral_dataset/')


def download(url, target_dir, overwrite=False, chunk_size=1024 * 1024):
    target = os.path.join(target_dir, os.path.basename(url))
    if os.path.exists(target) and not overwrite:
        print(f'{target} exists; use -f to overwrite')
        return target
    import requests
    os.makedirs(target_dir, exist_ok=True)
    size = int(requests.head(url).headers.get('Content-Length', 0))
    done = 0
    with requests.get(url, stream=True) as r, open(target, 'wb') as f:
        for chunk in r.iter_content(chunk_size=chunk_size):
            done += f.write(chunk)
            print(f'\r{os.path.basename(url)}: {done / 1e6:.1f} of '
                  f'{size / 1e6:.1f} MB', end='', flush=True)
    print()
    return target


def main(argv=None):
    parser = argparse.ArgumentParser(description='Download multipoint dataset')
    parser.add_argument('--test-url', default=BASE_URL + 'test.hdf5')
    parser.add_argument('--train-url', default=BASE_URL + 'training.hdf5')
    parser.add_argument('--labels-url',
                        default=BASE_URL + 'labels_training.hdf5')
    parser.add_argument('-f', '--force-overwrite', action='store_true')
    parser.add_argument('-d', '--target-dir', default='data')
    args = parser.parse_args(argv)
    return [download(url, args.target_dir, args.force_overwrite)
            for url in (args.test_url, args.train_url, args.labels_url)]


if __name__ == '__main__':
    main()
