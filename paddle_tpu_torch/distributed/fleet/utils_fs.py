"""Filesystem clients for checkpoints and datasets (a copy of
``paddle_tpu/distributed/fleet/utils_fs.py``, plain Python).

Reference parity: python/paddle/distributed/fleet/utils/fs.py:423 — the
FS interface, LocalFS, HDFSClient (which shells out to ``hadoop fs``).
HDFSClient keeps the same surface and raises a clear error when no hadoop
binary exists on the host.
"""
import os
import shutil
import subprocess


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        return False

    def rename(self, src, dst):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def cat(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError


class LocalFS(FS):
    """Reference: fs.py:119."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path)
        elif os.path.exists(fs_path):
            os.remove(fs_path)

    def rename(self, src, dst):
        os.rename(src, dst)

    def mv(self, src, dst, overwrite=False, test_exists=False):
        if test_exists and not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if not overwrite and self.is_exist(dst):
            raise FSFileExistsError(dst)
        shutil.move(src, dst)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        open(fs_path, "a").close()

    def cat(self, fs_path):
        with open(fs_path) as f:
            return f.read()

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]


class HDFSClient(FS):
    """Reference: fs.py:423 — shells out to `hadoop fs`. Surfaces the
    same API; requires a hadoop binary on PATH."""

    def __init__(self, hadoop_home=None, configs=None, time_out=300000,
                 sleep_inter=1000):
        self._hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                        if hadoop_home else shutil.which("hadoop"))
        self._configs = configs or {}
        if self._hadoop is None or not os.path.exists(self._hadoop):
            raise ExecuteError(
                "no hadoop binary available on this host; pass hadoop_home "
                "or use LocalFS")

    def _run(self, *args):
        cmd = [self._hadoop, "fs"]
        for k, v in self._configs.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += list(args)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ExecuteError(f"{' '.join(cmd)}: {proc.stderr}")
        return proc.stdout

    def ls_dir(self, fs_path):
        out = self._run("-ls", fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, fs_path):
        try:
            self._run("-test", "-e", fs_path)
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path):
        try:
            self._run("-test", "-f", fs_path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path):
        try:
            self._run("-test", "-d", fs_path)
            return True
        except ExecuteError:
            return False

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        self._run("-rm", "-r", "-f", fs_path)

    def rename(self, src, dst):
        self._run("-mv", src, dst)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return  # -touchz would truncate the existing file
        self._run("-touchz", fs_path)

    def cat(self, fs_path):
        return self._run("-cat", fs_path)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def need_upload_download(self):
        return True
