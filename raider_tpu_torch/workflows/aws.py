"""S3 helpers for HyP3 GUNW jobs.

The counterpart of ``raider_tpu/workflows/aws.py``. boto3 is imported only
where a client is made (``_client``).
"""

from mimetypes import guess_type
from pathlib import Path
from typing import Optional, Union

from raider_tpu_torch.logger import logger


def _client():
    import boto3

    return boto3.client('s3')


def get_content_type(file_location: Union[Path, str]) -> str:
    content_type = guess_type(file_location)[0]
    return content_type or 'application/octet-stream'


def upload_file_to_s3(path_to_file: Union[str, Path], bucket: str, prefix: str = '') -> None:
    path_to_file = Path(path_to_file)
    key = str(Path(prefix) / path_to_file)
    extra_args = {'ContentType': get_content_type(key)}
    logger.info('Uploading s3://%s/%s', bucket, key)
    client = _client()
    client.upload_file(str(path_to_file), bucket, key, extra_args)
    client.put_object_tagging(
        Bucket=bucket, Key=key,
        Tagging={'TagSet': [{'Key': 'file_type', 'Value': 'product'}]},
    )


def get_s3_file(bucket_name: str, bucket_prefix: str, file_type: str) -> Optional[Path]:
    client = _client()
    result = client.list_objects_v2(Bucket=bucket_name, Prefix=bucket_prefix)
    # boto3 omits 'Contents' entirely when nothing matches the prefix
    for s3_object in result.get('Contents', ()):
        key = s3_object['Key']
        if key.endswith(file_type):
            file_name = Path(key).name
            logger.info('Downloading s3://%s/%s to %s', bucket_name, key, file_name)
            client.download_file(bucket_name, key, file_name)
            return Path(file_name)
    return None
