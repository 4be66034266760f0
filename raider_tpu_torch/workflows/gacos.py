"""GACOS product support: generate GDAL VRT headers for .ztd grids.

The counterpart of ``raider_tpu/workflows/gacos.py``. GACOS distributes
zenith delay grids as flat binary float32 .ztd files with an .rsc sidecar;
a VRT (and an ENVI .hdr, which ``raider_tpu_torch.io.rasters.read_envi``
reads) makes them readable by standard tooling.

    python -m raider_tpu_torch.workflows.gacos file.ztd [...]
"""

import os
from pathlib import Path


def parse_rsc(rsc_path) -> dict:
    fields = {}
    for line in Path(rsc_path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            fields[parts[0].strip()] = parts[1].strip()
    return fields


def makeVRT(filename, dtype: str = 'Float32') -> str:
    """Write a .vrt (and ENVI .hdr) beside a GACOS .ztd file; returns the
    .vrt's path."""
    rsc = parse_rsc(str(filename) + '.rsc')
    width = int(rsc['WIDTH'])
    length = int(rsc['FILE_LENGTH'])
    x_first = float(rsc['X_FIRST'])
    y_first = float(rsc['Y_FIRST'])
    x_step = float(rsc['X_STEP'])
    y_step = float(rsc['Y_STEP'])

    vrt = f"""<VRTDataset rasterXSize="{width}" rasterYSize="{length}">
    <SRS>EPSG:4326</SRS>
    <GeoTransform>{x_first}, {x_step}, 0.0, {y_first}, 0.0, {y_step}</GeoTransform>
    <VRTRasterBand band="1" dataType="{dtype}" subClass="VRTRawRasterBand">
        <SourceFilename relativeToVRT="1">{os.path.basename(str(filename))}</SourceFilename>
        <ByteOrder>LSB</ByteOrder>
        <ImageOffset>0</ImageOffset>
        <PixelOffset>4</PixelOffset>
        <LineOffset>{4 * width}</LineOffset>
    </VRTRasterBand>
</VRTDataset>
"""
    vrt_path = str(filename) + '.vrt'
    Path(vrt_path).write_text(vrt)

    # ENVI header so raider_tpu_torch.io.rasters can read the grid directly
    hdr = '\n'.join([
        'ENVI',
        f'samples = {width}',
        f'lines = {length}',
        'bands = 1',
        'header offset = 0',
        'file type = ENVI Standard',
        'data type = 4',
        'interleave = bsq',
        'byte order = 0',
        'map info = {Geographic Lat/Lon, 1, 1, %s, %s, %s, %s, WGS-84}'
        % (x_first, y_first, x_step, abs(y_step)),
    ]) + '\n'
    Path(str(filename) + '.hdr').write_text(hdr)
    return vrt_path


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description='Generate VRT + ENVI headers for GACOS .ztd grids')
    p.add_argument('files', nargs='+', help='.ztd files (with .rsc sidecars)')
    args = p.parse_args(argv)
    for f in args.files:
        print(makeVRT(f))


if __name__ == '__main__':
    main()
