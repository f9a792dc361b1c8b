"""Version info of the port: release / version / codename, with
`get_short()` = "release-codename", as ``odgi_tpu/version.py`` has them."""

RELEASE = "v0.1.0"
VERSION = RELEASE + "-torch"
CODENAME = "systolic pangenome"


def get_release() -> str:
    return RELEASE


def get_version() -> str:
    return VERSION


def get_codename() -> str:
    return CODENAME


def get_short() -> str:
    return f"{RELEASE}-{CODENAME}"
